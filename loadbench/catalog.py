"""Everything a cell is made of, found by name: ``BENCHMARK.json`` at the
root of the checkout, ``configs/<name>.json``, ``traffic/<name>.json``,
``workloads/<name>.json``, and the code files ``traffic/kinds/<kind>.py``,
``entries/<entry>.py``, ``metrics/<metric>.py``, the configuration's
``families/<family>.py`` and ``reference/<family>.py``, and the cell's
``checks/<check>.py``, loaded by path (their names may hold dots and
dashes)."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent  # the checkout


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def load_module(kind: str, name: str) -> ModuleType:
    """``loadbench/<kind>/<name>.py`` as a module."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"loadbench.{kind.replace('/', '.')}.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict  # the HF config.json keys, plus source, reduced, assumed, layerskip, family
    traffic_name: str
    traffic: dict
    entry: str
    chips: int
    settings: dict

    @property
    def exit_layer(self) -> int:
        return int(self.config["layerskip"]["exit_layer"])

    @property
    def num_speculations(self) -> int:
        return int(self.config["layerskip"]["num_speculations"])

    @property
    def tail_eps(self) -> float:
        return float(self.config["layerskip"]["tail_eps"])

    @property
    def family(self) -> str:
        """The configuration's model family (its weights, program build and
        reference): its ``family`` key, ``mistral`` where it has none."""
        return str(self.config.get("family", "mistral"))

    @property
    def check(self) -> str:
        """The comparison that decides ``correct``: the ``check`` setting,
        ``gap`` where the cell names none."""
        return str(self.settings.get("check", "gap"))


def cell(name: str) -> Cell:
    w = _json(HERE / "workloads" / f"{name}.json")
    return Cell(name=name, config_name=w["config"], config=_json(HERE / "configs" /
                                                                  f"{w['config']}.json"),
                traffic_name=w["traffic"],
                traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                entry=w["entry"], chips=int(w["chips"]), settings=w["settings"])


def metrics_for(cell_name: str, table: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries of ``BENCHMARK.json`` that
    this cell reports."""
    return [m for m in benchmark()[table]
            if "workloads" not in m or cell_name in m["workloads"]]
