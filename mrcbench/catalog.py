"""The benchmark's data, found by name: one file a configuration, traffic
mix, cell and metric.

    configs/<config>.json     codec settings, clip length, clips a request,
                              source, assumed, reduced
    traffic/<mix>.json        entry point, generator and the seed of its
                              clips, distinct clips, ring slots
                              (requests), PCM dtype, calls and clips
                              compared, warm-up calls, traced requests
    workloads/<cell>.json     config, traffic, chips, why
    metrics/<metric>.json     kind (end_to_end or per_layer), unit, better,
                              source, reader and its arguments; per-layer:
                              layer, moves; workloads (the cells that
                              report it; all cells where absent)

Adding a cell, a mix or a metric is adding its file. A new cell brings the
files of its own metrics, end-to-end ones included, each listing it in
`workloads` (as `corpus_rtf` is the batch's), so no file on disk changes.
"""
from __future__ import annotations

import json
import os
import re

ROOT = os.path.dirname(os.path.abspath(__file__))
KINDS = ("configs", "traffic", "workloads", "metrics")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class Catalog:
    """The files under `root` (the package's directory by default)."""

    def __init__(self, root: str = ROOT):
        self.root = root

    def names(self, kind: str) -> list[str]:
        d = os.path.join(self.root, kind)
        return sorted(f[:-5] for f in os.listdir(d) if f.endswith(".json"))

    def load(self, kind: str, name: str) -> dict:
        if kind not in KINDS:
            raise ValueError(f"no kind {kind!r}")
        if not NAME.match(name):
            raise ValueError(f"bad name {name!r}")
        path = os.path.join(self.root, kind, name + ".json")
        if not os.path.exists(path):
            raise KeyError(f"no {kind[:-1] if kind != 'traffic' else kind} "
                           f"named {name!r}")
        with open(path) as f:
            return dict(json.load(f), name=name)

    def cell(self, name: str) -> dict:
        """The cell with its config and traffic mix in place of their
        names."""
        cell = self.load("workloads", name)
        cell["config"] = self.load("configs", cell["config"])
        cell["traffic"] = self.load("traffic", cell["traffic"])
        return cell

    def metrics(self, cell: str, kind: str) -> list[dict]:
        """The metrics of `kind` that this cell reports."""
        out = []
        for n in self.names("metrics"):
            m = self.load("metrics", n)
            if m["kind"] == kind and cell in m.get("workloads", [cell]):
                out.append(m)
        return out
