"""Judge a served answer against the reference, and the control.

``expected`` gives, for one request the generator drew, the summary the
reference states: ``exists`` and, past boolean granularity, ``count``
(the generator draws no other granularity). ``served`` reads the
same summary out of the server's body. ``control`` is the reference
with one of the configuration's guarantees broken (``window_cap``:
the device's window cap applied with no host fallback, so a window
wider than the cap loses rows; ``half_datasets``: only the first half of
the datasets, in order, answers a query over all of them), put where
the served answer would be.
"""

from __future__ import annotations

import json

from .beacon_ref import Query, VocabTables, dataset_answer, variants_summary


class Judge:
    def __init__(self, datasets, *, window_cap: int,
                 control: str | None = None):
        self.by_id = {d.dataset_id: d for d in datasets}
        self.tabs = {}
        for d in datasets:
            key = tuple(d.vocab)
            self.tabs.setdefault(key, VocabTables(d.vocab))
        self.window_cap = window_cap
        self.control = control

    def _tabs(self, ds):
        return self.tabs[tuple(ds.vocab)]

    def expected(self, check: dict, *, control: bool = False) -> dict:
        q = Query(check["rp"], granularity=check["granularity"],
                  include="HIT")
        ids = sorted(check["datasets"])
        if control and self.control == "half_datasets" and len(ids) > 1:
            ids = ids[: len(ids) // 2]
        cap = (self.window_cap
               if control and self.control == "window_cap" else None)
        return variants_summary(
            [dataset_answer(self.by_id[i], self._tabs(self.by_id[i]), q,
                            cap=cap) for i in ids], q)

    @staticmethod
    def served(check: dict, text: str) -> dict:
        doc = json.loads(text)
        rs = doc["responseSummary"]
        out = {"exists": rs["exists"]}
        if check["granularity"] == "boolean":
            return out
        out["count"] = rs["numTotalResults"]
        return out

    def judge(self, check: dict, status: int, text: str) -> str | None:
        """None when the answer is right, else what is wrong."""
        if status != 200:
            return f"status {status}"
        try:
            got = self.served(check, text)
        except (ValueError, KeyError, IndexError, TypeError) as e:
            return f"unreadable body: {e!r}"
        if got != self.expected(check):
            return "answer differs from the reference"
        return None
