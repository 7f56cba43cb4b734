"""Host helpers (port of magphase_tpu/utils)."""
from .futil import (DimProtect, fileparts, indexes_to_one_zero_vector,
                    ins_date_time, ins_pid, is_mutable, read_text_file2,
                    round_to_int)
from .padding import FRM_STEP, SIG_STEP, bucket, bucket_signal, pad_to
from .parallel_map import run_multithreaded

__all__ = ["bucket", "bucket_signal", "pad_to", "SIG_STEP", "FRM_STEP",
           "run_multithreaded", "DimProtect", "fileparts",
           "indexes_to_one_zero_vector", "ins_date_time", "ins_pid",
           "is_mutable", "read_text_file2", "round_to_int"]
