"""Terminal streamers, with draft repaint for speculative decoding (port of
``layerskip_tpu/generation/streamer.py``; the same bytes for the same calls).

Draft tokens are printed at once (magenta, newlines escaped), then erased
with backspace-space-backspace and replaced by the accepted tokens (green)
once the round's verify lands, driven by ``Engine.stream_generate``'s
per-round callback. Token ids may come as lists, arrays or tensors.
"""

from __future__ import annotations

import sys
import threading
from typing import List

import numpy as np
import torch



def _token_list(token_ids) -> List[int]:
    """A flat list of ints from a list, an array or a tensor on any device."""
    if isinstance(token_ids, torch.Tensor):
        return [int(t) for t in token_ids.reshape(-1).tolist()]
    return [int(t) for t in np.asarray(token_ids).reshape(-1).tolist()]


MAGENTA = "\033[35m"
GREEN = "\033[32m"
RESET = "\033[0m"


class TextStreamer:
    """Plain incremental detokenizing streamer (as HF ``TextStreamer``)."""

    def __init__(self, tokenizer, skip_special_tokens: bool = True, out=None):
        self.tokenizer = tokenizer
        self.skip_special_tokens = skip_special_tokens
        self.out = out or sys.stdout
        self._tokens: List[int] = []
        self._printed = ""

    def _decode(self, tokens: List[int]) -> str:
        try:
            return self.tokenizer.decode(
                tokens, skip_special_tokens=self.skip_special_tokens
            )
        except TypeError:
            return self.tokenizer.decode(tokens)

    def put(self, token_ids, **kwargs) -> None:
        self._tokens.extend(_token_list(token_ids))
        text = self._decode(self._tokens)
        if text.endswith("�"):  # wait for a complete multi-byte char
            return
        new = text[len(self._printed):]
        if new:
            self._write(new)
            self._printed = text

    def _write(self, s: str) -> None:
        self.out.write(s)
        self.out.flush()

    def end(self) -> None:
        self._write("\n")
        self._tokens, self._printed = [], ""


class SpeculativeTextStreamer(TextStreamer):
    """Streamer with draft paint/erase.

    ``put(..., is_draft=True)`` prints tokens in magenta with newlines
    escaped (so ``delete`` can erase them with backspaces); ``delete(n)``
    removes the last n tokens from the terminal. ``non_blocking`` puts from
    a thread of their own.
    """

    def __init__(self, tokenizer, non_blocking: bool = False, **kw):
        super().__init__(tokenizer, **kw)
        self.non_blocking = non_blocking
        self._draft_tokens: List[int] = []
        self._draft_printed = 0  # chars printed for the draft tail
        self._lock = threading.Lock()

    def _escape(self, s: str) -> str:
        return s.replace("\n", "\\n")

    def put(self, token_ids, is_draft: bool = False, **kwargs) -> None:
        if self.non_blocking:
            t = threading.Thread(target=self._put_sync, args=(token_ids, is_draft))
            t.start()
            return
        self._put_sync(token_ids, is_draft)

    def _put_sync(self, token_ids, is_draft: bool) -> None:
        with self._lock:
            ids = _token_list(token_ids)
            if not is_draft:
                # finalize: drafts should have been deleted already
                self._tokens.extend(ids)
                text = self._decode(self._tokens)
                new = text[len(self._printed):]
                if new:
                    self._write(GREEN + new + RESET)
                    self._printed = text
                return
            self._draft_tokens.extend(ids)
            draft_text = self._escape(
                self._decode(self._tokens + self._draft_tokens)[len(self._printed):]
            )
            add = draft_text[self._draft_printed:]
            if add:
                self._write(MAGENTA + add + RESET)
                self._draft_printed = len(draft_text)

    def delete(self, num_tokens: int) -> None:
        """Erase the last ``num_tokens`` draft tokens from the terminal
        (backspace-space-backspace repaint)."""
        with self._lock:
            if num_tokens <= 0:
                return
            keep = self._draft_tokens[: max(len(self._draft_tokens) - num_tokens, 0)]
            new_text = self._escape(
                self._decode(self._tokens + keep)[len(self._printed):]
            ) if keep else ""
            erase = self._draft_printed - len(new_text)
            if erase > 0:
                self._write("\b \b" * erase)
            self._draft_tokens = keep
            self._draft_printed = len(new_text)

    def delete_all_drafts(self) -> None:
        self.delete(len(self._draft_tokens))

    def end(self) -> None:
        self.delete_all_drafts()
        super().end()
