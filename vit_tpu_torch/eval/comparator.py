"""Golden-file comparator — counterpart of ``vit_tpu.eval.comparator``.

Parses ``[i] label: L / prob: P`` lines (the reference format, which
``vit_tpu_torch.io.results`` writes) from a result file and a golden file
and gates them: the label exact and |Δprob| ≤ 0.01, over every golden line
unless a count is given (the reference gates the first line only).  Rows
pair by their parsed index, so one dropped or corrupt line misreports only
itself.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

PROB_TOLERANCE = 0.01

_LINE_RE = re.compile(r"^\[(\d+)\]\s*label:\s*(\d+)\s*/\s*prob:\s*([0-9.eE+-]+)\s*$")
_INDEX_PREFIX_RE = re.compile(r"^\[(\d+)\]")


class ResultLine(NamedTuple):
    index: int
    label: int
    prob: float


@dataclasses.dataclass(frozen=True)
class Mismatch:
    index: int
    kind: str  # 'label' | 'prob' | 'format' | 'missing'
    got: Optional[ResultLine]
    want: Optional[ResultLine]

    def __str__(self) -> str:
        return f"[{self.index}] {self.kind}: got {self.got}, want {self.want}"


def parse_line(line: str) -> Optional[ResultLine]:
    m = _LINE_RE.match(line.strip())
    if not m:
        return None
    try:
        prob = float(m.group(3))
    except ValueError:  # the character class admits strings float() rejects
        return None
    return ResultLine(int(m.group(1)), int(m.group(2)), prob)


def _parse_lines(path) -> Tuple[List[ResultLine], List[int]]:
    """-> (parsed lines, indices of the non-empty lines that did not parse):
    a corrupt line keeps its ``[i]`` prefix where it has one, else its
    ordinal among the non-empty lines."""
    lines: List[ResultLine] = []
    bad: List[int] = []
    ordinal = 0
    for raw in Path(path).read_text().splitlines():
        if not raw.strip():
            continue
        parsed = parse_line(raw)
        if parsed is None:
            prefix = _INDEX_PREFIX_RE.match(raw.strip())
            bad.append(int(prefix.group(1)) if prefix else ordinal)
        else:
            lines.append(parsed)
        ordinal += 1
    return lines, bad


def parse_result_file(path) -> List[ResultLine]:
    """The well-formed lines of a result file, in order."""
    return _parse_lines(path)[0]


def compare_results(got: Sequence[ResultLine], want: Sequence[ResultLine],
                    count: Optional[int] = None,
                    prob_tolerance: float = PROB_TOLERANCE) -> List[Mismatch]:
    """Label exact and |Δprob| ≤ tol over the first ``count`` golden
    indices (default every golden line), paired by index."""
    want_by = {w.index: w for w in want}
    got_by = {g.index: g for g in got}
    indices = sorted(want_by) if count is None else range(count)
    errors: List[Mismatch] = []
    for i in indices:
        w, g = want_by.get(i), got_by.get(i)
        if w is None or g is None:
            errors.append(Mismatch(i, "missing", g, w))
        elif g.label != w.label:
            errors.append(Mismatch(i, "label", g, w))
        elif abs(g.prob - w.prob) > prob_tolerance:
            errors.append(Mismatch(i, "prob", g, w))
    return errors


def compare_files(result_path, golden_path, count: Optional[int] = None,
                  prob_tolerance: float = PROB_TOLERANCE) -> List[Mismatch]:
    """:func:`compare_results` over two files, with one 'format' mismatch
    for each corrupt line (and no second 'missing' one for its hole)."""
    got, got_bad = _parse_lines(result_path)
    want, want_bad = _parse_lines(golden_path)
    bad = set(got_bad) | set(want_bad)
    errors = [Mismatch(i, "format", None, None) for i in sorted(bad) if count is None or i < count]
    errors += [e for e in compare_results(got, want, count=count, prob_tolerance=prob_tolerance)
               if not (e.kind == "missing" and e.index in bad)]
    return errors
