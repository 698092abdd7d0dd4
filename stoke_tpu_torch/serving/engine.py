"""Continuous-batching serving engine: prefill/decode over a paged KV cache.

Counterpart of ``stoke_tpu/serving/engine.py:115-1220`` for the greedy
path. Two forwards, as in the JAX engine's two compiled programs
(``_prefill_fn`` and ``_decode_fn``):

- **prefill**: one request at a time, the prompt zero-padded to a
  ``prefill_pad_multiple`` bucket, causal attention through the configured
  kernel (``attention="flash"``: the flash forward kernel), every prompt
  K/V written into the request's blocks, and the first token the argmax of
  the logits at ``prompt_len - 1`` (the TTFT point);
- **decode**: all ``max_seqs`` slots every step, one fresh token per slot,
  attention over each slot's cached blocks (``decode_kernel="pallas"``:
  the paged-decode kernel). Inactive slots run against the scratch block
  and their outputs are discarded, so the step's shape never changes.

The block tables, positions and context lengths are copied to the device
each step in one pinned host-to-device copy; the only synchronisation is
the fetch of the tokens. The port runs under ``torch.inference_mode()``.

Left out of this slice, and refused at construction with
``NotImplementedError``: sampling, speculative decoding, chunked prefill,
weight quantization, and the SLO and cost observatories. Tracing and the
memory observatory are left out too.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from stoke_tpu_torch.configs import ServeConfig
from stoke_tpu_torch.models.bert import BERT_SIZES
from stoke_tpu_torch.models.gpt import GPT
from stoke_tpu_torch.serving.kv_cache import (
    BlockAllocator,
    PagedAttentionHook,
    PagedKVCache,
)
from stoke_tpu_torch.serving.scheduler import Request, Scheduler
from stoke_tpu_torch.serving.telemetry import ServeMetrics
from stoke_tpu_torch.telemetry.registry import MetricsRegistry

_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_LATER_SERVING = (
    "ROADMAP Queue 1 item 3 (serving: sampling, speculative decoding, "
    "chunked prefill, weight quantization)"
)
_LATER_TELEMETRY = (
    "ROADMAP Queue 1 item 10 (telemetry: the serve SLO and cost "
    "observatories)"
)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises when the card is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "stoke_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def _unsupported(cfg: ServeConfig) -> Optional[str]:
    """The first feature ``cfg`` turns on that this slice does not serve,
    with the ROADMAP item that ports it."""
    later = {
        "sampling": (cfg.sampling, _LATER_SERVING),
        "temperature": (cfg.temperature != 0.0, _LATER_SERVING),
        "top_k": (cfg.top_k is not None, _LATER_SERVING),
        "top_p": (cfg.top_p is not None, _LATER_SERVING),
        "speculative_k": (cfg.speculative_k is not None, _LATER_SERVING),
        "prefill_chunk_tokens": (
            cfg.prefill_chunk_tokens is not None, _LATER_SERVING
        ),
        "quant": (cfg.quant != "none", _LATER_SERVING),
        "cost_cards": (cfg.cost_cards, _LATER_TELEMETRY),
        "slo_ttft_target_s": (
            cfg.slo_ttft_target_s is not None, _LATER_TELEMETRY
        ),
        "slo_tpot_target_s": (
            cfg.slo_tpot_target_s is not None, _LATER_TELEMETRY
        ),
    }
    for name, (on, item) in later.items():
        if on:
            return f"ServeConfig.{name} is not ported yet: {item}"
    return None


class ServingEngine:
    """Continuous-batching inference engine over one GPT model.

    Args:
        model: a :class:`~stoke_tpu_torch.models.gpt.GPT`. The engine
            loads ``weights`` into it and moves it to ``device``.
        weights: the model's ``state_dict()`` (for example from
            :func:`stoke_tpu_torch.convert.gpt_state_dict_from_jax`), or a
            module whose ``state_dict()`` it takes.
        cfg: :class:`~stoke_tpu_torch.configs.ServeConfig`.
        device: ``None`` or ``"cuda"`` runs on the card (and raises when
            there is none); ``"cpu"`` runs on the CPU, where the kernels'
            plain versions run.
    """

    def __init__(
        self,
        model: GPT,
        weights: Union[Dict[str, torch.Tensor], nn.Module],
        cfg: ServeConfig,
        *,
        device=None,
    ):
        self.device = resolve_device(device)
        if not isinstance(model, GPT):
            raise TypeError(
                f"ServingEngine serves GPT models; got {type(model).__name__}"
            )
        reason = _unsupported(cfg)
        if reason is not None:
            raise NotImplementedError(reason)
        knobs = ("decode_pages_per_block", "decode_block_h",
                 "verify_pages_per_block", "verify_block_h")
        for knob in knobs:
            if getattr(cfg, knob) is not None:
                raise ValueError(
                    f"ServeConfig.{knob} is a TPU kernel's block knob; the "
                    f"CUDA kernels choose their own tiles, leave it None"
                )
        if cfg.attention not in ("dense", "flash"):
            raise ValueError(
                f"ServeConfig.attention={cfg.attention!r}; valid: "
                f"['dense', 'flash']"
            )
        if cfg.decode_kernel not in ("reference", "pallas"):
            raise ValueError(
                f"ServeConfig.decode_kernel={cfg.decode_kernel!r}; valid: "
                f"['reference', 'pallas']"
            )
        if cfg.kv_dtype not in _KV_DTYPES:
            raise ValueError(
                f"ServeConfig.kv_dtype={cfg.kv_dtype!r}; valid: "
                f"{sorted(_KV_DTYPES)}"
            )
        if cfg.max_seq_len > model.max_len:
            raise ValueError(
                f"ServeConfig.max_seq_len={cfg.max_seq_len} exceeds the "
                f"model's max_len={model.max_len}"
            )
        if _round_up(cfg.max_seq_len, cfg.prefill_pad_multiple) > model.max_len:
            raise ValueError(
                f"prefill padding bucket round_up(max_seq_len="
                f"{cfg.max_seq_len}, {cfg.prefill_pad_multiple}) exceeds the "
                f"model's max_len={model.max_len}; shrink max_seq_len or "
                f"prefill_pad_multiple"
            )
        if isinstance(weights, nn.Module):
            weights = weights.state_dict()
        self.model = model.to(self.device)
        self.model.load_state_dict(weights)
        self.model.eval()
        self.cfg = cfg
        self.metrics = ServeMetrics(MetricsRegistry())

        size = BERT_SIZES[model.size_name]
        max_blocks_per_seq = -(-cfg.max_seq_len // cfg.kv_block_size)
        num_blocks = (
            cfg.kv_blocks
            if cfg.kv_blocks is not None
            else cfg.max_seqs * max_blocks_per_seq + 1  # +1 scratch
        )
        self.cache = PagedKVCache(
            size.num_layers, num_blocks, cfg.kv_block_size, size.heads,
            size.hidden // size.heads, dtype=_KV_DTYPES[cfg.kv_dtype],
            device=self.device,
        )
        self.allocator = BlockAllocator(num_blocks, cfg.kv_block_size)
        self.scheduler = Scheduler(
            cfg.max_seqs,
            self.allocator,
            max_blocks_per_seq,
            max_seq_len=cfg.max_seq_len,
            default_max_new_tokens=cfg.max_new_tokens,
            eos_id=cfg.eos_id,
            pad_multiple=cfg.prefill_pad_multiple,
        )
        self._iterations = 0
        self._t_start = time.perf_counter()

    # ------------------------------------------------------------------ #
    # the two forwards
    # ------------------------------------------------------------------ #

    def _upload(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Copy int32 host arrays to the device in one copy (pinned and
        asynchronous on the card) and return device views of each."""
        flat = np.concatenate(
            [np.ascontiguousarray(a, np.int32).reshape(-1) for a in arrays]
        )
        host = torch.from_numpy(flat)
        if self.device.type == "cuda":
            host = host.pin_memory()
        buf = host.to(self.device, non_blocking=True)
        views, at = [], 0
        for a in arrays:
            views.append(buf[at : at + a.size].view(a.shape))
            at += a.size
        return views

    def _hook(self, tables, positions, mode: str, lengths):
        return PagedAttentionHook(
            self.cache.k_pages, self.cache.v_pages, tables, positions,
            mode=mode, lengths=lengths,
            attention_impl=self.cfg.attention,
            decode_impl=self.cfg.decode_kernel,
        )

    def _prefill(self, padded: np.ndarray, block_row: np.ndarray,
                 prompt_len: int) -> int:
        """``padded [1, P]`` prompt, ``block_row [1, MB]``: write the
        prompt's K/V and return the first generated token."""
        P = padded.shape[1]
        tokens, tables, plen = self._upload(
            padded, block_row, np.array([prompt_len])
        )
        positions = torch.arange(P, dtype=torch.int32, device=self.device)[None]
        hook = self._hook(tables, positions, "prefill", plen)
        logits = self.model(tokens, positions, kv_cache=hook)
        return int(logits[0, prompt_len - 1].argmax())  # sync: the TTFT point

    def _decode(self) -> np.ndarray:
        """One decode step over all slots; returns the next tokens [B]."""
        tokens, positions, tables, context = self._upload(
            *self.scheduler.decode_batch()
        )
        hook = self._hook(tables, positions[:, None], "decode", context)
        logits = self.model(
            tokens[:, None], positions[:, None], decode=True, kv_cache=hook
        )
        # sync: the tokens stream out
        return logits[:, -1, :].argmax(dim=-1).cpu().numpy()

    # ------------------------------------------------------------------ #
    # request intake
    # ------------------------------------------------------------------ #

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None) -> int:
        """Enqueue one request (mid-flight is the point); returns its id."""
        rid = self.scheduler.submit(prompt, max_new_tokens, eos_id)
        self.metrics.requests.inc()
        return rid

    def result(self, rid: int) -> Optional[Request]:
        return self.scheduler.finished.get(rid)

    # ------------------------------------------------------------------ #
    # the engine loop
    # ------------------------------------------------------------------ #

    def _prefill_one(self, slot: int, req: Request, padded: np.ndarray,
                     plen: int) -> None:
        sched, m = self.scheduler, self.metrics
        t0 = time.perf_counter()
        tok = self._prefill(padded, sched.block_tables[slot : slot + 1], plen)
        now = time.perf_counter()
        m.prefills.inc()
        m.prefill_s.inc(now - t0)
        sched.note_prefill_token(slot, tok, now)
        m.tokens_out.inc()
        m.observe_ttft(req.ttft_s)
        if req.finished:
            self._finish(req)

    def step(self) -> bool:
        """One engine iteration: prefill the admitted arrivals, then one
        decode step over the slot batch. Returns True while work remains."""
        sched, m = self.scheduler, self.metrics
        with torch.inference_mode():
            for slot, req, padded, plen in sched.admit():
                self._prefill_one(slot, req, padded, plen)
            if sched.active > 0:
                t0 = time.perf_counter()
                next_host = self._decode()
                now = time.perf_counter()
                m.decode_steps.inc()
                m.decode_s.inc(now - t0)
                was_finished = set(sched.finished)
                m.tokens_out.inc(sched.commit_decode(next_host, now))
                for rid in set(sched.finished) - was_finished:
                    self._finish(sched.finished[rid])
        self._iterations += 1
        self._refresh_gauges()
        return sched.has_work

    def run(self, max_steps: Optional[int] = None) -> int:
        """Drive :meth:`step` until drained (or ``max_steps``); returns the
        iterations run."""
        n = 0
        while self.scheduler.has_work:
            self.step()
            n += 1
            if max_steps is not None and n >= max_steps:
                break
        return n

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: Optional[int] = None) -> List[List[int]]:
        """Submit all, drain, return the token lists in prompt order (the
        continuous batcher still interleaves them)."""
        rids = [self.submit(p, max_new_tokens) for p in prompts]
        self.run()
        return [list(self.scheduler.finished[r].tokens) for r in rids]

    # ------------------------------------------------------------------ #
    # accounting
    # ------------------------------------------------------------------ #

    def _finish(self, req: Request) -> None:
        self.metrics.completed.inc()
        if req.tpot_s is not None:
            self.metrics.observe_tpot(req.tpot_s)

    def _refresh_gauges(self) -> None:
        m, sched = self.metrics, self.scheduler
        m.queue_depth.set(sched.queued)
        m.active_seqs.set(sched.active)
        m.batch_fill.set(sched.batch_fill)
        m.kv_blocks_used.set(self.allocator.used_blocks)
        m.kv_occupancy.set(self.allocator.occupancy)
        # sums-to-wall: queue/idle is the wall neither forward used
        wall = time.perf_counter() - self._t_start
        target = max(0.0, wall - m.prefill_s.value - m.decode_s.value)
        if target > m.queue_s.value:
            m.queue_s.inc(target - m.queue_s.value)

    def summary(self) -> Dict[str, Any]:
        m = self.metrics
        m.refresh_percentiles()
        return {
            "device": str(self.device),
            "iterations": self._iterations,
            "requests": m.requests.value,
            "completed": m.completed.value,
            "tokens_out": m.tokens_out.value,
            "prefills": m.prefills.value,
            "decode_steps": m.decode_steps.value,
            "kv_blocks_used": self.allocator.used_blocks,
            "kv_block_occupancy": self.allocator.occupancy,
            "kv_cache_bytes": self.cache.nbytes,
            **m.latency_percentiles(),
            "goodput_s": {
                "queue": m.queue_s.value,
                "prefill": m.prefill_s.value,
                "decode": m.decode_s.value,
            },
        }
