"""The plain reference: every answer of the service's JSON statements,
worked out again from the generated fact rows with plain PyTorch.

It reads the rows in load order, as the benchmark generated them: it
takes nothing that the program derived (no sort, no index, no store).
Each filter is a boolean mask over the rows, each aggregate a masked
reduction; group-bys are ``index_add_`` over ``a * card(b) + b``, exact in
int64 on any device.

``judge(statement, response)`` says whether a response of ``POST /query``
carries the reference's answer, exactly.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class Reference:
    def __init__(self, rows: np.ndarray, columns: Sequence[str],
                 cards: Dict[str, int], measures: Dict[str, np.ndarray],
                 device="cpu"):
        self.device = torch.device(device)
        self.cards = dict(cards)
        self.cols = {c: torch.as_tensor(rows[:, i]).to(self.device)
                     for i, c in enumerate(columns)}
        self.measures = {m: torch.as_tensor(v).to(self.device).to(torch.int64)
                         for m, v in measures.items()}
        self.n = len(rows)

    # -- filters -------------------------------------------------------------
    def mask(self, e: Optional[Dict]) -> torch.Tensor:
        if e is None:
            return torch.ones(self.n, dtype=torch.bool, device=self.device)
        op = e["op"]
        if op == "eq":
            return self.cols[e["col"]] == int(e["value"])
        if op == "in":
            vals = torch.tensor([int(v) for v in e["values"]],
                                device=self.device)
            return torch.isin(self.cols[e["col"]], vals)
        if op == "range":
            c = self.cols[e["col"]]
            m = torch.ones(self.n, dtype=torch.bool, device=self.device)
            if e.get("lo") is not None:
                m &= c >= int(e["lo"])
            if e.get("hi") is not None:
                m &= c <= int(e["hi"])
            return m
        if op in ("and", "or"):
            masks = [self.mask(a) for a in e["args"]]
            out = masks[0].clone()
            for m in masks[1:]:
                out = out & m if op == "and" else out | m
            return out
        raise ValueError(f"the reference has no op {op!r}")

    # -- aggregates ----------------------------------------------------------
    def _group(self, by: List[str], m: torch.Tensor, measure: str):
        """(counts, sums) over the cells of ``by``, flat, row-major."""
        key = torch.zeros(int(m.sum()), dtype=torch.int64,
                          device=self.device)
        size = 1
        for c in by:
            key = key * self.cards[c] + self.cols[c][m]
            size *= self.cards[c]
        counts = torch.bincount(key, minlength=size)
        sums = torch.zeros(size, dtype=torch.int64, device=self.device)
        sums.index_add_(0, key, self.measures[measure][m])
        return counts, sums

    def answer(self, st: Dict):
        """The reference's answer to one statement of the traffic
        generator (scalar and grouped sums), in the form that
        ``canonical`` gives a response."""
        sel, m = st["select"], self.mask(st.get("where"))
        if "sum" not in sel:
            raise ValueError(f"the reference has no select {sel!r}")
        if sel.get("by") is None:
            return ("sum", _num(self.measures[sel["sum"]][m].sum()),
                    int(m.sum()))
        counts, sums = self._group(list(sel["by"]), m, sel["sum"])
        return ("group", counts.tolist(), [_num(x) for x in sums.tolist()])

    def judge(self, st: Dict, response: Optional[Dict]) -> bool:
        """True when ``response`` is the reference's answer to ``st``."""
        if response is None:
            return False
        try:
            return canonical(st, response) == self.answer(st)
        except (KeyError, TypeError, ValueError):
            return False


def _num(x):
    x = x.item() if isinstance(x, torch.Tensor) else x
    return int(x) if float(x).is_integer() and abs(x) < 2 ** 62 else float(x)


def _flat(x) -> list:
    return np.asarray(x, dtype=object).reshape(-1).tolist()


def canonical(st: Dict, r: Dict):
    """A service response in the reference's answer form."""
    sel = st["select"]
    if sel.get("by") is None:
        return ("sum", _num(r["value"]), int(r["count"]))
    return ("group", [int(x) for x in _flat(r["counts"])],
            [_num(v) for v in _flat(r["values"])])
