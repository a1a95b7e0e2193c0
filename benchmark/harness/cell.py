"""A cell of BENCHMARK.json and the data files it names.

A cell (an entry of ``workloads``) names a configuration, whose sizes
are ``configs/<config>.json``, and a traffic mix, whose parameters are
``traffic/<traffic>.json``. The traffic file's ``kind`` names the module
under ``harness/kinds/`` that drives it. The metrics a cell reports are
the ``end_to_end`` and ``per_layer`` entries of BENCHMARK.json that list
it, or that list no cells and move an end-to-end metric it reports; a
per-layer metric is read by ``metrics/<name>.py``. So a cell, a
configuration, a traffic mix or a per-layer metric is added by adding
its files and its entry, with no edit to a file that is here.
"""

import json
import os
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

#: what the drivers and the reference build, key by key (a dotted key
#: names a nested one): a configuration that states another value is
#: refused rather than run as something it does not state
BUILT = {"backbone": "resnet50", "use_rnn": True, "rnn_hidden": 512,
         "rnn_layers": 2, "bidirectional": True, "step_cols": 4,
         "out_scale": 8, "dtype": "bfloat16", "fit_dtype": "float32",
         "layout": "general", "wire.format": "dct4",
         "train.optim": "Adam", "train.param_dtype": "float32",
         "train.lstm_bias": "folded"}


def check_config(config):
    """Refuse ``config`` where it states a value of BUILT's keys that the
    harness does not build."""
    for key, want in BUILT.items():
        v = config
        for part in key.split("."):
            v = v.get(part, want) if isinstance(v, dict) else want
        if v != want:
            raise SystemExit(f"configuration {config.get('name')!r} states "
                             f"{key} = {v!r}; the benchmark builds {want!r}")


def _load(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def kind(self):
        return self.traffic["kind"]


def _listed(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_cell(name, spec_path=None, bench_dir=BENCH_DIR):
    """The cell ``name`` of BENCHMARK.json (at the checkout's root unless
    ``spec_path``), with its configuration, traffic and metrics, read from
    ``bench_dir``."""
    spec = _load(spec_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    config = _load(os.path.join(bench_dir, "configs", w["config"] + ".json"))
    check_config(config)
    traffic = _load(os.path.join(bench_dir, "traffic",
                                 w["traffic"] + ".json"))
    e2e = [m for m in spec["end_to_end"] if _listed(m, name)]
    reported = {m["name"] for m in e2e if m["name"] != "setup_s"}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)
