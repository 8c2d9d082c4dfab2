"""Text and file helpers (port of clstm_tpu/utils/text.py; reference utils.h
read_text/split).

Python strings are already unicode, so the reference's utf8<->utf32
machinery reduces to plain ``str``; the .gt.txt reading convention (strip
the trailing newline) is kept.
"""

from __future__ import annotations

from typing import List, Optional


def read_text(fname: str) -> str:
    """Read a text file, stripping the trailing newline (reference
    read_text semantics for .gt.txt transcripts)."""
    with open(fname, "r", encoding="utf-8") as f:
        s = f.read()
    if s.endswith("\n"):
        s = s[:-1]
    if s.endswith("\r"):
        s = s[:-1]
    return s


def split(s: str, sep: Optional[str] = None) -> List[str]:
    """Whitespace (or sep) split skipping empties (reference split)."""
    return [p for p in s.split(sep) if p]
