"""Utterance-list (.scp) and misc file utilities (numpy-free copy of
magphase_tpu/io/scp.py).

Reference: libutils.py:94-109 (read_scp_file / read_text_file2 /
get_file_list), libutils.py:67-77 (gen_list_of_file_paths),
libutils.py:146-157 (mkdir), libutils.py:136-144 (fileparts/get_filename).
"""
from __future__ import annotations

import glob
import os


def read_scp_file(filename: str) -> list[str]:
    """Utterance tokens, one per line; '#' starts a comment, blank lines are
    skipped."""
    toks = []
    with open(filename) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                toks.append(line)
    return toks


def gen_list_of_file_paths(files_dir: str, file_tokens,
                           suffix: str) -> list[str]:
    return [os.path.join(files_dir, tok + suffix) for tok in file_tokens]


def get_file_list(files_path: str) -> tuple[list[str], int]:
    files_list = glob.glob(files_path)
    return files_list, len(files_list)


def get_filename(filepath: str) -> str:
    return os.path.splitext(os.path.basename(filepath))[0]


def mkdir(l_dir) -> None:
    if isinstance(l_dir, str):
        l_dir = [l_dir]
    for d in l_dir:
        os.makedirs(d, exist_ok=True)
