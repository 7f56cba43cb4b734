"""File I/O (port of magphase_tpu/io: wav, featfile, est, scp and labels,
numpy only; ``io.native`` binds the C++ corpus-IO runtime)."""
from .est import read_est_file, read_reaper_est_file, write_reaper_est_file
from .featfile import read_binfile, write_binfile, write_featfile
from .scp import (get_file_list, get_filename, gen_list_of_file_paths, mkdir,
                  read_scp_file)
from .wav import (read_audio_file, read_wav, read_wav_info, write_audio_file,
                  write_wav)

__all__ = [
    "read_wav", "read_wav_info", "write_wav", "read_audio_file",
    "write_audio_file", "read_binfile", "write_binfile", "write_featfile",
    "read_est_file", "read_reaper_est_file", "write_reaper_est_file",
    "read_scp_file", "gen_list_of_file_paths", "get_file_list",
    "get_filename", "mkdir",
]
