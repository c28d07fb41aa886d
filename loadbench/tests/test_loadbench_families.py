"""A configuration's family and a cell's check, found by name: the
``mistral`` family draws the same weights and the same reference logits as
before it was a family; a new family, configuration, cell and check come
in as new files only; what the program keeps for a request reaches the
check; the K1/K2 rooflines read the program's own records."""

import dataclasses
import hashlib
import json
import shutil
from pathlib import Path

import pytest
import torch

from loadbench import catalog, spans
from loadbench import run as bench
from loadbench.families.mistral import make_weights
from loadbench.reference import float32_exact
from loadbench.reference.mistral import logits_at
from loadbench.tests.tiny import tiny_cell

REPO = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


def _sha(t: torch.Tensor) -> str:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


# sha256 (first 16 hex digits) of each bf16 weight drawn from seed 2**31 + 5,
# and of the reference's float32 logits of two fixed sequences, at "fp32"
# and at the "fp8" control: computed with the code as it was before the
# family files (``loadbench/weights.py``, ``loadbench/reference/model.py``)
SHARED = {"attn_norm": "ad755ff209a358c0", "embed": "1fe6cd81190e36a9",
          "final_norm": "1ede9ebfa1ad011b", "mlp_norm": "ad755ff209a358c0",
          "wk": "9784d457ae2f4633", "wo": "1fb80135b554edc5", "wq": "a211a88811e9a922",
          "wv": "face9fa7335343ae"}
PINNED = {
    "dense": (dict(SHARED, lm_head="64a60a337aeb36a9", w_down="a73884766ef1504f",
                   w_gate="e91dfa99752c7246", w_up="d580e66c76ce54d4"),
              {"fp32": ["ea3a1d7aa83ee9f6", "a5c57cd03df78c0f"],
               "fp8": ["e2d030fff6b6fec7", "0352512102dea273"]}),
    "moe": (dict(SHARED, lm_head="c9bb277f97e4fafa", w_down="cea388fed213d417",
                 w_gate="48a4cc7afc0c1ee1", w_router="3cf109f91a510150",
                 w_up="261a1f1b4d58195d"),
            {"fp32": ["9c1a80191173666b", "ba07714ba663d17c"],
             "fp8": ["97bbf77989afd694", "a1b13cefada6ed72"]}),
}


@pytest.mark.parametrize("which", sorted(PINNED))
def test_the_mistral_family_draws_the_weights_and_logits_it_drew_before(which):
    cell = tiny_cell(moe=which == "moe")
    w = make_weights(cell.config, cell.exit_layer, cell.tail_eps, 2 ** 31 + 5, CPU)
    weights, logits = PINNED[which]
    assert {k: _sha(v) for k, v in w.items()} == weights
    g = torch.Generator().manual_seed(4)
    seqs = [torch.randint(3, 512, (n,), generator=g).tolist() for n in (40, 23)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with float32_exact():
            for precision, want in logits.items():
                out = logits_at(w, cell.config, seqs, [(30, 40), (10, 23)], precision)
                assert [_sha(o) for o in out] == want, precision
    finally:
        torch.set_num_threads(threads)


# ---- a new family, configuration, cell and check as new files only --------

QK_FAMILY = '''"""A tiny qk-norm family: the mistral family's weights with per-head q
and k RMSNorms before RoPE (Qwen3's attention), and the program built with
them."""

import torch

from loadbench.families import mistral

WITH_QK_NORM = {with_qk}


def shapes(hf):
    out = dict(mistral.shapes(hf))
    dh = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
    out["q_norm"] = out["k_norm"] = (hf["num_hidden_layers"], dh)
    return out


def make_weights(hf, exit_layer, tail_eps, seed, device, dtype=torch.bfloat16):
    w = mistral.make_weights(hf, exit_layer, tail_eps, seed, device, dtype)
    gen = torch.Generator(device=device).manual_seed((int(seed) + 1) & (2 ** 64 - 1))
    for name in ("q_norm", "k_norm"):
        noise = torch.randn(shapes(hf)[name], generator=gen, device=device)
        w[name] = (1.0 + 0.5 * noise).to(dtype)
    return w


def engine(cell, weights, device):
    from layerskip_tpu_torch.config import ModelConfig
    from layerskip_tpu_torch.generation.engine import Engine
    from layerskip_tpu_torch.models.llama import LayerParams, LlamaParams

    w = weights
    norms = dict(q_norm=w["q_norm"], k_norm=w["k_norm"]) if WITH_QK_NORM else {{}}
    layers = LayerParams(
        attn_norm=w["attn_norm"], wq=w["wq"], wk=w["wk"], wv=w["wv"], wo=w["wo"],
        mlp_norm=w["mlp_norm"], w_gate=w["w_gate"], w_up=w["w_up"], w_down=w["w_down"],
        **norms)
    params = LlamaParams(embed=w["embed"], layers=layers, final_norm=w["final_norm"],
                         lm_head=w["lm_head"])
    return Engine(params, ModelConfig.from_hf_dict(cell.config, dtype=torch.bfloat16),
                  device=device)


def model_shape(hf):
    return mistral.model_shape(hf)
'''

QK_REFERENCE = '''"""Plain forward pass of a dense decoder whose attention norms q and k
by head before RoPE (Qwen3), with global attention."""

import torch

from loadbench.reference.mistral import _Ops, _attention, _cos_sin, _mlp, _rms, _rope


@torch.no_grad()
def logits_at(w, hf, seqs, spans, precision="fp32"):
    ops = _Ops(precision)
    dev = w["embed"].device
    d, hq, hkv = hf["hidden_size"], hf["num_attention_heads"], hf["num_key_value_heads"]
    dh = hf.get("head_dim") or d // hq
    eps = float(hf["rms_norm_eps"])
    out = []
    for seq, (start, stop) in zip(seqs, spans):
        ids = torch.as_tensor(list(seq), dtype=torch.long, device=dev)
        t = len(ids)
        h = w["embed"][ids].float()
        cos, sin = _cos_sin(t, dh, float(hf["rope_theta"]), dev)
        for i in range(hf["num_hidden_layers"]):
            x = _rms(h, w["attn_norm"][i], eps)
            q = ops.lin(x, ops.weight(w["wq"][i].t())).reshape(t, hq, dh)
            k = ops.lin(x, ops.weight(w["wk"][i].t())).reshape(t, hkv, dh)
            v = ops.lin(x, ops.weight(w["wv"][i].t())).reshape(t, hkv, dh)
            q = _rope(_rms(q, w["q_norm"][i], eps), cos, sin)
            k = _rope(_rms(k, w["k_norm"][i], eps), cos, sin)
            h = h + ops.lin(_attention(q, k, v, 0, ops), ops.weight(w["wo"][i]))
            x = _rms(h, w["mlp_norm"][i], eps)
            h = h + _mlp(x, *(ops.weight(w[n][i]) for n in ("w_gate", "w_up", "w_down")),
                         ops)
        out.append(ops.lin(_rms(h[start:stop], w["final_norm"], eps),
                           ops.weight(w["lm_head"])))
    return out
'''

WORST_GAP = '''"""The widest gap of a served token's reference logit below the
reference's best, named ``worst_gap``."""

import torch

from loadbench.check import positions
from loadbench.reference import float32_exact


def read(reference, weights, hf, requests):
    seqs, spans = positions(requests)
    with float32_exact():
        ref = reference.logits_at(weights, hf, seqs, spans, "fp32")
    worst = 0.0
    for r, lg in zip(requests, ref):
        tok = torch.as_tensor(r.tokens, device=lg.device)
        gap = lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return {"worst_gap": worst}
'''

RECORDS_SEEN = '''"""How many judged requests lack the record the program kept for them."""


def read(reference, weights, hf, requests):
    bad = sum(1 for r in requests if r.records.get("prompt_len") != len(r.prompt))
    return {"unrecorded": float(bad)}
'''

# sound runs of the qk-norm cell (the program built with its norms) read a
# worst gap of 0-0.0033 on seeds 2**31 + 7, 2**31 + 8, 1, 2 and 3; the
# program built without them reads 0.44-0.67 on the same seeds
QK_LIMIT = 0.05


def _tree(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def copy(tmp_path, monkeypatch):
    """A copy of ``loadbench/`` and ``BENCHMARK.json`` that the catalog reads
    from, and the hashes of its files before anything is added."""
    here = tmp_path / "loadbench"
    shutil.copytree(REPO / "loadbench", here,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    monkeypatch.setattr(catalog, "HERE", here)
    monkeypatch.setattr(catalog, "ROOT", tmp_path)
    return here, _tree(here)


def _add_qk_cell(here: Path, with_qk: bool) -> None:
    tiny = tiny_cell(window=0)
    cfg = dict(tiny.config, family="qk-tiny", model_type="qwen3",
               architectures=["Qwen3ForCausalLM"], head_dim=32, sliding_window=None)
    files = {
        "families/qk-tiny.py": QK_FAMILY.format(with_qk=with_qk),
        "reference/qk-tiny.py": QK_REFERENCE,
        "checks/worst_gap.py": WORST_GAP,
        "configs/qk-tiny.json": json.dumps(cfg),
        "traffic/tiny-chat.json": json.dumps(tiny.traffic),
        "workloads/qk-tiny.chat.json": json.dumps(
            {"config": "qk-tiny", "traffic": "tiny-chat", "entry": "scheduler", "chips": 1,
             "settings": dict(tiny.settings, check="worst_gap",
                              limits={"worst_gap": QK_LIMIT})}),
    }
    for name, text in files.items():
        (here / name).write_text(text)


def _judged(cell, seed):
    run, peak, compared = bench.measure(cell, seed, 3.0, False, CPU)
    return bench.result_line(cell, run, peak, compared, False, CPU)["correct"], compared


@pytest.mark.parametrize("seed", [2 ** 31 + 7, 2 ** 31 + 8])
def test_a_new_family_and_check_come_in_as_new_files_and_hold_the_program(copy, seed):
    here, before = copy
    _add_qk_cell(here, with_qk=True)
    cell = catalog.cell("qk-tiny.chat")
    assert (cell.family, cell.check) == ("qk-tiny", "worst_gap")
    ok, compared = _judged(cell, seed)
    assert ok, compared
    assert compared["worst_gap"]["value"] < QK_LIMIT
    # the same cell with a program built without its q and k norms
    _add_qk_cell(here, with_qk=False)
    ok, compared = _judged(catalog.cell("qk-tiny.chat"), seed)
    assert not ok
    assert compared["worst_gap"]["value"] > QK_LIMIT
    after = _tree(here)
    assert {k: after[k] for k in before} == before
    assert sorted(set(after) - set(before)) == sorted(
        ["checks/worst_gap.py", "configs/qk-tiny.json", "families/qk-tiny.py",
         "reference/qk-tiny.py", "traffic/tiny-chat.json", "workloads/qk-tiny.chat.json"])


def test_the_family_and_check_default_to_mistral_and_gap():
    cell = catalog.cell("mistral-7b.chat")
    assert "family" not in cell.config and "check" not in cell.settings
    assert (cell.family, cell.check) == ("mistral", "gap")


# ---- what the program keeps for a request reaches the check ----------------

def test_records_on_a_future_reach_request_and_check(copy, monkeypatch):
    from layerskip_tpu_torch.serving import ContinuousBatchScheduler

    here, _ = copy
    (here / "checks" / "records_seen.py").write_text(RECORDS_SEEN)
    base = tiny_cell()
    cell = dataclasses.replace(base, settings=dict(base.settings, check="records_seen",
                                                   limits={"unrecorded": 0}))
    # no future carries records today: every judged request lacks them
    ok, compared = _judged(cell, 3)
    assert not ok and compared["unrecorded"]["value"] > 0

    submit = ContinuousBatchScheduler.submit

    def recording(self, prompt, *a, **kw):
        fut = submit(self, prompt, *a, **kw)
        fut.records = {"prompt_len": len(prompt)}
        return fut

    monkeypatch.setattr(ContinuousBatchScheduler, "submit", recording)
    run, peak, compared = bench.measure(cell, 3, 3.0, False, CPU)
    assert compared["unrecorded"]["value"] == 0
    assert all(r.records == {"prompt_len": len(r.prompt)}
               for r in run.window_requests if r.tokens is not None)
    w = make_weights(cell.config, cell.exit_layer, cell.tail_eps, 3, CPU)
    control = bench.judge(cell, run, w, 3, control=True)
    assert control["unrecorded"]["value"] == 0


# ---- the K1/K2 rooflines read the program's own records --------------------

@pytest.fixture
def recorded(monkeypatch):
    from layerskip_tpu_torch.utils import profiling

    from loadbench.record import Run
    from loadbench.yardstick.trace import DeviceSummary

    records = profiling.KernelRecords()
    monkeypatch.setattr(profiling, "RECORDS", records)
    device = DeviceSummary(busy_s=1.0, window_s=2.0, kernels=3,
                           kernel_s_by_name={"paged_decode_kernel<bf16>": 30e-9,
                                             "flash_prefill_tc_kernel": 20e-9},
                           kernel_count_by_name={}, range_device_s={})
    return Run(cell="hand", seconds=2.0, window=(10.0, 12.0), device=device), records


@pytest.mark.parametrize("name,kind,fragment", [
    ("k2_roofline.chat", "k2", "paged_decode_kernel"),
    ("k1_roofline.longdoc", "k1", "flash_prefill")])
def test_the_rooflines_read_the_programs_records(recorded, name, kind, fragment):
    from loadbench.yardstick.peaks import MEM_BYTES_PER_S

    run, records = recorded
    reader = catalog.load_module("metrics", name)
    assert reader.read(run) is None  # no call recorded
    # a K2 call of two rows at positions 3 and 5 over 8 slots (4 + 6 keys),
    # the same call replayed by a graph, and a K1 prompt block of 4 at past 0
    pos = torch.tensor([[3], [5]])
    records.add("k2", ((2, 1, 1, 64), pos, 1, 8, 0, 2))
    records.add("k2", ((2, 1, 1, 64), pos, 1, 8, 0, 2))
    records.add("k1", ((1, 4, 1, 64), 4, 1, 0, 0, 2))
    got = reader.read(run)
    assert got == spans.roofline_from_records(run, kind, fragment)
    hand = {"k2": 2 * 2 * (2 * 2 * 64 + 2 * 10 * 64) / MEM_BYTES_PER_S / 30e-9 * 100,
            "k1": 2 * (2 * 4 * 64 + 2 * 4 * 64) / MEM_BYTES_PER_S / 20e-9 * 100}
    assert got == pytest.approx(hand[kind])
    assert spans.records_count() == {"k1": 1, "k2": 2, "dropped": 0}
    run.device = None
    assert reader.read(run) is None

