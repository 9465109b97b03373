"""Chunked prefill: the paged engine's second program.

The dense serve loop prefills token by token through the decode step:
O(prompt_len) step dispatches per request.  :class:`ChunkedPrefill` runs the
model's ``prefill_chunk`` with a fixed chunk width K instead, so ingest costs
O(prompt_len / K) dispatches.  The JAX package compiles that chunk once
(``jax.jit``) and every chunk of every request of every length reuses the one
program.  Its counterpart here: on a CUDA state the chunk program is captured
once as a CUDA graph, at the first chunk, and replayed for every chunk after;
the chunk's tokens, ``slot`` and ``n_valid`` are copied into static tensors
on the device before each replay (:class:`Staged`), and the block table and
positions are the decode state's own static tensors.  On the CPU, and with
``eager=True`` on the card (a measurement and test hook), the chunk runs
eagerly.

The model is handed in by the caller (the engine or a test); this package
never imports ``repro_torch.models``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.serve.serve_loop import Staged, capture_graph


class ChunkedPrefill:
    """Feeds a prompt into a paged decode state K tokens per dispatch.

    ``model`` needs a ``prefill_chunk(state, tokens, slot, n_valid,
    policy=...)`` method (``DecoderLM``).  ``step`` runs one chunk — the unit
    the scheduler interleaves with decode ticks; ``ingest`` loops a whole
    prompt.  The program is bound to the first decode state it is given (a
    captured graph reads that state's tensors); ``captures`` counts its
    captures (one per CUDA instance) and ``dispatches`` its invocations.
    """

    def __init__(self, model, *, chunk: int = 32, policy=None,
                 eager: bool = False):
        if chunk < 1:
            raise ValueError(f"prefill chunk must be >= 1, got {chunk}")
        if not hasattr(model, "prefill_chunk"):
            raise NotImplementedError(
                f"{type(model).__name__} has no prefill_chunk (chunked "
                "paged prefill needs an attention-cache family)")
        self.model = model
        self.chunk = int(chunk)
        self.policy = policy
        self.eager = eager
        self.dispatches = 0           # program invocations issued
        self.captures = 0             # CUDA graph captures (at most one)
        self._state = None            # the decode state the program reads
        self._graph = None
        self._logits = None

    def num_chunks(self, prompt_len: int) -> int:
        return -(-int(prompt_len) // self.chunk)

    def _bind(self, state):
        if self._state is None:
            dev = state["pos"].device
            self._state = state
            # tokens (K,), slot (1,) and n_valid (1,): one device buffer
            self._inputs = torch.zeros((self.chunk + 2,), dtype=torch.int64,
                                       device=dev)
            self._staged = Staged(self._inputs)
            self._use_graph = dev.type == "cuda" and not self.eager
        elif state is not self._state:
            raise ValueError("a ChunkedPrefill runs on the one decode state "
                             "it was first given")

    def _run(self) -> torch.Tensor:
        """The chunk on the bound state's static tensors: the arena is
        written in place and the advanced positions are copied back into
        ``state["pos"]``.  Returns the (1, 1, V) float32 logits."""
        k = self.chunk
        logits, new = self.model.prefill_chunk(
            self._state, self._inputs[:k], self._inputs[k:k + 1],
            self._inputs[k + 1:], policy=self.policy)
        self._state["pos"].copy_(new["pos"])
        return logits.to(torch.float32)

    @torch.inference_mode()
    def step(self, state, prompt, fed: int, slot: int):
        """Feed ONE chunk of ``prompt`` starting at token ``fed`` into
        ``slot``.  Returns ``(logits, state, fed')`` where ``logits`` is the
        last *valid* position's (1, 1, V) float32 logits on the device —
        meaningful when ``fed' == len(prompt)`` (the first sampled token for
        free) — and ``state`` is the one given, updated in place."""
        self._bind(state)
        part = np.asarray(prompt[fed:fed + self.chunk], np.int64)
        buf = np.zeros((self.chunk + 2,), np.int64)
        buf[:len(part)] = part
        buf[self.chunk:] = (slot, len(part))
        self._staged.push(buf)
        if self._use_graph:
            if self._graph is None:
                caches = state["caches"]
                self._graph, self._logits = capture_graph(
                    self._run, [caches["k"], caches["v"], state["pos"]],
                    state["pos"].device)
                self.captures += 1
            self._graph.replay()
            logits = self._logits
        else:
            logits = self._run()
        self.dispatches += 1
        return logits, state, fed + len(part)

    def ingest(self, state, prompt, slot: int):
        """Feed a whole prompt; returns ``(last_logits, state)``."""
        fed, logits = 0, None
        while fed < len(prompt):
            logits, state, fed = self.step(state, prompt, fed, slot)
        return logits, state
