"""Printing and file-system helpers (``stoke_tpu/utils/printing.py``)."""

from __future__ import annotations

import os
from typing import Any, Iterable, Union


def unrolled_print(value: Union[str, Iterable[Any]],
                   single_line: bool = False) -> None:
    """Print a string, or each string of an iterable, with the
    ``Stoke --`` prefix; ``single_line`` joins an iterable's items with
    commas on one line."""
    if isinstance(value, str):
        print(f"Stoke -- {value}")
        return
    items = list(value)
    if single_line:
        print("Stoke -- " + ", ".join(str(v) for v in items))
    else:
        for v in items:
            print(f"Stoke -- {v}")


def make_folder(path: str) -> str:
    """Create a directory if needed and return its absolute path."""
    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(path, exist_ok=True)
    return path
