"""Codec: charset <-> class-index mapping.

Reference: ``Codec`` in clstm.h/clstm.cc (≈L1000-1100, unverified) — a
vector of unicode codepoints with a reverse hash; class 0 is reserved for
the CTC blank/epsilon. Persisted into the .clstm proto as an int array.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, List, Sequence


class Codec:
    """codepoint table; index 0 == CTC blank (codepoint 0)."""

    def __init__(self, codepoints: Sequence[int] = (0,)):
        cps = list(codepoints)
        if not cps or cps[0] != 0:
            cps = [0] + [c for c in cps if c != 0]
        self.codec: List[int] = cps
        self._enc = {c: i for i, c in enumerate(self.codec)}
        # Out-of-codec characters silently skipped by encode() would
        # silently deflate CER; count them so callers can report.
        self.dropped: Counter = Counter()

    @classmethod
    def build(cls, texts: Iterable[str]) -> "Codec":
        """Build from training transcripts: unique codepoints, sorted, after
        the reserved blank (reference Codec::build)."""
        chars = set()
        for t in texts:
            chars.update(ord(c) for c in t)
        chars.discard(0)
        return cls([0] + sorted(chars))

    def size(self) -> int:
        return len(self.codec)

    def __len__(self) -> int:
        return len(self.codec)

    def encode(self, s: str, strict: bool = False) -> List[int]:
        """utf-8/unicode string -> class ids. Unknown chars are skipped and
        counted in ``self.dropped`` (strict=True raises instead; reference
        behavior on unknowns is assert-like — low confidence, see SURVEY.md
        §2 Codec row)."""
        out = []
        for ch in s:
            i = self._enc.get(ord(ch))
            if i is None:
                if strict:
                    raise KeyError(f"codec: unknown char {ch!r}")
                self.dropped[ch] += 1
                continue
            out.append(i)
        return out

    def dropped_report(self) -> str:
        """One-line human-readable summary of encode() drops ('' if none)."""
        if not self.dropped:
            return ""
        total = sum(self.dropped.values())
        tops = ", ".join(f"{ch!r}x{n}" for ch, n in
                         self.dropped.most_common(8))
        return (f"codec: dropped {total} out-of-codec char(s) "
                f"({len(self.dropped)} distinct): {tops}")

    def decode(self, ids: Iterable[int]) -> str:
        """class ids -> string; blank (0) decodes to nothing."""
        return "".join(chr(self.codec[i]) for i in ids if 0 < i < len(self.codec))
