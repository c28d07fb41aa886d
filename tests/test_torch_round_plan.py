"""The round plan (generation/core.py ``RoundPlan``): ``Engine.round_plan``
resolves each draft source once, and the solo loop and a continuous session
of the same config run the same plan."""

import dataclasses

import pytest
import torch

from layerskip_tpu_torch.config import GenerationConfig, tiny_config
from layerskip_tpu_torch.generation import engine as engine_mod
from layerskip_tpu_torch.generation.engine import Engine
from layerskip_tpu_torch.models.params import init_params

EOS = (300,)  # past the vocabulary: every request runs to its budget
PROMPT = [3, 17, 52, 9, 40, 3, 17]
SPEC = dict(generation_strategy="self_speculative", exit_layer=1, num_speculations=3)

# config -> (source, exit layer, lookup n, tree width, drafter bits or 0);
# prompt lookup without an exit layer splits at L // 2 = 2 of the 4 layers
CASES = {
    "early_exit": (SPEC, ("early_exit", 1, 0, 0, 0)),
    "adaptive": (dict(SPEC, draft_exit_prob=0.3), ("adaptive", 1, 0, 0, 0)),
    "lookup_default_exit": (dict(generation_strategy="prompt_lookup", num_speculations=3,
                                 pld_ngram=2), ("lookup", 2, 2, 0, 0)),
    "hybrid": (dict(SPEC, generation_strategy="hybrid", pld_ngram=2), ("hybrid", 1, 2, 0, 0)),
    "tree": (dict(SPEC, spec_tree_width=2, draft_quant=8), ("tree", 1, 0, 2, 0)),
    "early_exit_int8_drafter": (dict(SPEC, draft_quant=8), ("early_exit", 1, 0, 0, 8)),
}


@pytest.fixture(scope="module")
def engine():
    cfg = tiny_config(vocab_size=128)
    return Engine(init_params(cfg, seed=3, device="cpu"), cfg, device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_the_builder_resolves_each_source_once(case, engine, monkeypatch):
    """The plan's source, exit layer, lookup n, tree width and drafter; the
    plan ``generate`` runs and a session's plan equal it (a session takes
    the default split only as an explicit exit layer)."""
    kw, (source, exit_layer, pld, width, bits) = CASES[case]
    gen = GenerationConfig(max_steps=6, sample=False, **kw)
    plan = engine.round_plan(gen, EOS)
    assert (plan.source, plan.exit_layer, plan.pld_ngram, plan.tree_width) == \
        (source, exit_layer, pld, width)
    if bits:
        assert plan.draft_params is engine._draft_cache[(exit_layer, bits, False, False)]
    else:
        assert plan.draft_params is None
    assert plan.eos_ids == EOS and not plan.scfg.sample

    ran = []
    real = engine_mod.spec_generate
    monkeypatch.setattr(engine_mod, "spec_generate",
                        lambda *a, **k: ran.append(a[5]) or real(*a, **k))
    out = engine.generate(PROMPT, gen, eos_ids=EOS)
    assert ran == [plan] and int(out.num_tokens[0]) == 6
    session = engine.continuous_session(dataclasses.replace(gen, exit_layer=exit_layer), 2,
                                        16, EOS)
    assert session.plan == plan
    session.insert([0], [PROMPT])
    while session.has_active():
        done = session.step(4)
    assert done and done[0][0] == 0 and len(done[0][1]) == 6
    assert torch.equal(session.state.out[0, :6], out.tokens[0, :6])
