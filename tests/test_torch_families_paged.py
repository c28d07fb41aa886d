"""Paged continuous sessions and tree speculation of the windowed families
(Mistral, Gemma-2, Gemma-3) in the PyTorch port, on the CPU in fp32, against
the JAX package's paged sessions and the port's own solo and AR streams.

The models are tests/test_torch_families.py's (head_dim 64, so paged decode
runs K2's and K3's plain versions, with the 8-token window clause and, for
trees, the tree clause). Streams and per-row counters must be EQUAL.
"""

import numpy as np
import pytest

from layerskip_tpu.config import GenerationConfig as JGenerationConfig
from layerskip_tpu_torch.config import GenerationConfig
from layerskip_tpu_torch.generation.engine import postprocess_output
from test_torch_families import (  # noqa: F401 (an autouse fixture)
    EOS, PROMPT, V, _engines, _gen, _one_torch_thread)

WINDOWED = ("mistral", "gemma2", "gemma3")


_SESSION_PROMPTS = [[int(x) for x in np.random.default_rng(10 + i).integers(3, V, size=n)]
                    for i, n in enumerate((11, 3, 16, 7))]
_BUDGETS = [16, 9, 12, 16]


def _drive(session):
    """Two requests to completion, then two more into the same slots; the
    results and each finished row's (matches, drafts)."""
    results, counters = {}, {}
    for wave in (0, 2):
        session.insert([0, 1], _SESSION_PROMPTS[wave:wave + 2], seeds=[0, 0],
                       max_tokens=_BUDGETS[wave:wave + 2])
        while session.has_active():
            for r, toks, _ in session.step(max_rounds=3):
                results[wave + r] = toks
                counters[wave + r] = (int(session.state.matches[r]),
                                      int(session.state.drafts[r]))
    return results, counters


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp32_pool", "int8_pool"])
@pytest.mark.parametrize("family", WINDOWED)
def test_paged_session_equals_jax_and_solo(family, kv_quant):
    """A paged continuous session (pages of 16, K2's or K3's plain version
    under the window clause) == the JAX package's paged session (streams
    and per-row counters) == solo ``generate`` of each request."""
    je, te = _engines(family)
    paged = dict(paged_pool_pages=8, page_size=16)
    got, counts = _drive(te.continuous_session(
        _gen(GenerationConfig, "self_speculative", kv_quant=kv_quant), 2, 16, EOS, **paged))
    want, jcounts = _drive(je.continuous_session(
        _gen(JGenerationConfig, "self_speculative", kv_quant=kv_quant), 2, 16, EOS, **paged))
    assert got == want and counts == jcounts
    for i, budget in enumerate(_BUDGETS):
        solo = te.generate(_SESSION_PROMPTS[i], _gen(GenerationConfig, "self_speculative",
                                                     max_steps=budget, kv_quant=kv_quant),
                           eos_ids=EOS)
        assert got[i] == postprocess_output(solo, EOS, budget) and len(got[i]) == budget


@pytest.mark.parametrize("family", WINDOWED)
def test_tree_speculation_equals_ar(family):
    """Tree speculation (2 chains a round) == greedy AR, with drafts made."""
    _, te = _engines(family)
    ar = postprocess_output(te.generate(PROMPT, _gen(GenerationConfig, "autoregressive"),
                                        eos_ids=EOS), EOS, 16)
    out = te.generate(PROMPT, _gen(GenerationConfig, "self_speculative", spec_tree_width=2),
                      eos_ids=EOS)
    assert postprocess_output(out, EOS, 16) == ar and int(out.drafts) > 0
