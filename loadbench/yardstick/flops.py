"""Model FLOPs of the work a request needs, whatever computes it.

A token at position p (0-based) costs 2 × the matmul weights it passes
through (every layer's attention projections, its MLP or its top-k experts
and router), plus 4 · Hq · Dh per key it sees in each layer (scores and the
weighted sum), where it sees ``min(p + 1, window)`` keys. A token whose
logits are used also costs the head, 2 · D · V. A prompt of P tokens is
counted once at its true length, with the head once for its last position
(the first output token); each later output token once at its context.
Drafts, rejected tokens, padding and recomputation are not work delivered.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelShape:
    vocab: int
    hidden: int
    ffn: int
    layers: int
    q_heads: int
    kv_heads: int
    head_dim: int
    window: int  # 0: global attention
    experts: int  # 0: dense MLP
    experts_per_token: int

    @staticmethod
    def from_hf(hf: dict) -> "ModelShape":
        dh = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
        return ModelShape(
            vocab=hf["vocab_size"], hidden=hf["hidden_size"], ffn=hf["intermediate_size"],
            layers=hf["num_hidden_layers"], q_heads=hf["num_attention_heads"],
            kv_heads=hf["num_key_value_heads"], head_dim=dh,
            window=int(hf.get("sliding_window") or 0),
            experts=int(hf.get("num_local_experts") or 0),
            experts_per_token=int(hf.get("num_experts_per_tok") or 0))

    def layer_weights(self) -> int:
        """Matmul weights one token passes through in one layer."""
        d, dh = self.hidden, self.head_dim
        attn = d * self.q_heads * dh * 2 + d * self.kv_heads * dh * 2
        mlp = 3 * d * self.ffn
        if self.experts:
            return attn + self.experts_per_token * mlp + d * self.experts
        return attn + mlp

    def _keys(self, start: int, stop: int) -> int:
        """Sum over positions p in [start, stop) of min(p + 1, window)."""
        def upto(n):  # sum over p in [0, n) of min(p + 1, w)
            w = self.window
            if w <= 0 or n <= w:
                return n * (n + 1) // 2
            return w * (w + 1) // 2 + (n - w) * w
        return upto(stop) - upto(start)

    def tokens_flops(self, start: int, stop: int, head: int) -> float:
        """FLOPs of the tokens at positions [start, stop), ``head`` of them
        through the head."""
        n = stop - start
        per_token = 2.0 * self.layers * self.layer_weights()
        attn = 4.0 * self.q_heads * self.head_dim * self.layers * self._keys(start, stop)
        return n * per_token + attn + head * 2.0 * self.hidden * self.vocab

    def prompt_flops(self, prompt_len: int) -> float:
        """A prompt, its head once (the first output token)."""
        return self.tokens_flops(0, prompt_len, 1)

    def output_flops(self, prompt_len: int, first: int, stop: int) -> float:
        """Output tokens of 0-based index ``first .. stop - 1``, with first >= 1
        (token 0 is the prompt's): token j runs token j - 1 at position
        prompt_len + j - 1 and reads the head."""
        if stop <= first:
            return 0.0
        return self.tokens_flops(prompt_len + first - 1, prompt_len + stop - 1, stop - first)
