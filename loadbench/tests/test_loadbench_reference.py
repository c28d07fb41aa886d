"""The plain reference against the port's own CPU path at a tiny size."""

import pytest
import torch

from loadbench.families.mistral import engine, make_weights
from loadbench.reference import fp8_round
from loadbench.reference.mistral import logits_at
from loadbench.tests.tiny import tiny_cell


def _port_logits(cell, w, ids):
    from layerskip_tpu_torch.config import ModelConfig
    from layerskip_tpu_torch.generation.core import _mk_group_cache
    from layerskip_tpu_torch.models import llama

    cfg = ModelConfig.from_hf_dict(cell.config, dtype=torch.float32)
    params = engine(cell, w, torch.device("cpu")).params
    cache = _mk_group_cache(cfg, cfg.num_hidden_layers, 1, len(ids), torch.device("cpu"),
                            False)
    with torch.inference_mode():
        out = llama.forward(params, cfg, torch.tensor([ids]), cache, 0)
    return out.logits[0]


@pytest.mark.parametrize("moe,window", [(False, 48), (False, 0), (True, 0)])
def test_reference_agrees_with_the_port_in_float32(moe, window):
    cell = tiny_cell(moe=moe, window=window)
    w = make_weights(cell.config, cell.exit_layer, 0.5, 3, torch.device("cpu"),
                     dtype=torch.float32)
    ids = torch.randint(3, 512, (80,), generator=torch.Generator().manual_seed(1)).tolist()
    want = _port_logits(cell, w, ids)
    got = logits_at(w, cell.config, [ids], [(0, len(ids))])[0]
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)


def test_the_window_changes_the_reference():
    cell, wide = tiny_cell(window=8), tiny_cell(window=0)
    w = make_weights(cell.config, cell.exit_layer, 0.5, 3, torch.device("cpu"),
                     dtype=torch.float32)
    ids = list(range(3, 43))
    a = logits_at(w, cell.config, [ids], [(30, 40)])[0]
    b = logits_at(w, wide.config, [ids], [(30, 40)])[0]
    assert (a - b).abs().max() > 1e-3


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.tensor([[1.0, 1.0625, 448.0, -3.3]])
    y = fp8_round(x, dim=-1)
    assert y[0, 0] == 1.0 and y[0, 1] == 1.0 and y[0, 2] == 448.0
    assert abs(float(y[0, 3]) + 3.3) < 0.13

