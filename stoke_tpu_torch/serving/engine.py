"""Continuous-batching serving engine: prefill/decode over a paged KV cache.

Counterpart of ``stoke_tpu/serving/engine.py:115-1220``. The JAX engine's
compiled programs are methods here, run eagerly:

- **prefill**: one request at a time, the prompt zero-padded to a
  ``prefill_pad_multiple`` bucket, causal attention through the configured
  kernel (``attention="flash"``: the flash forward kernel), every prompt
  K/V written into the request's blocks, and the first token drawn from
  the logits at ``prompt_len - 1`` (the TTFT point);
- **decode**: all ``max_seqs`` slots every step, one fresh token per slot,
  attention over each slot's cached blocks (``decode_kernel="pallas"``:
  the paged-decode kernel). Inactive slots run against the scratch block
  and their outputs are discarded, so the step's shape never changes;
- **chunk** (``prefill_chunk_tokens``): a long prompt is prefilled one
  fixed-size chunk per iteration, attending the paged prefix
  (:func:`~stoke_tpu_torch.ops.paged_prefill_chunk_attention`), so one
  long prompt cannot stall the decode batch. A speculative engine packs
  every prefilling slot's chunk into one ``[max_seqs, C]`` batch;
- **verify** (``speculative_k``): replaces decode. The prompt-lookup
  drafter proposes up to k tokens per slot from its own history; one
  forward scores the pending token and the drafts as S = k+1 query rows
  (``decode_kernel="pallas"``: the paged-verify kernel); the S true draws
  come from the slot's key stream; the leading exact matches are kept and
  the rejected rows' K/V are rolled back out of the pool. Each emitted
  token is the token the non-speculative engine would draw, so streams
  are the same; only the dispatch count changes.

With ``ServeConfig(sampling=True)`` every draw goes through
:mod:`~stoke_tpu_torch.serving.sampling` (temperature / top-k / top-p,
Gumbel-max on a per-request threefry key stream, one split per emitted
token); the greedy engine (``sampling=False``) runs the argmax programs.

The key streams advance on the host (a split is a few words per slot);
the sub keys, block tables, positions, lengths and sampling knobs are
copied to the device each step in one pinned host-to-device copy, and
each dispatch synchronises once, to fetch its tokens (and a verify step's
acceptance counts in the same copy). When no row of a dispatch samples,
the draw is the argmax, which is what the sampler gives at temperature 0.
The port runs under ``torch.inference_mode()``.

``ServeConfig(quant="int8" | "bf16")`` quantizes the weights once at
construction (:mod:`~stoke_tpu_torch.serving.quant`, in the JAX package's
leaf order and layout) and keeps only the quantized store on the device;
every dispatch dequantizes it (int8: the dequantize kernel, one launch a
leaf) and runs the model on the result through
``torch.func.functional_call``. ``compression`` and the per-leaf
``quant_errors`` are computed once, as the JAX engine does.

With a ``TraceConfig`` run (a registered trace recorder,
:func:`~stoke_tpu_torch.telemetry.tracing.tracing_active`) the engine
records the JAX package's spans: ``serve/prefill``,
``serve/prefill_chunk``, ``serve/decode_step`` and ``serve/verify_step``
on the ``serve`` track, each request's ``serve/admission`` and per-step
``serve/decode`` slices on its own timeline (by ``request_id``, the
request's ``rid``), and a ``serve/evict`` point at each finish. Without
one, none of that bookkeeping runs.

Left out, and refused at construction with ``NotImplementedError``
naming ROADMAP item 10c: the SLO and cost observatories, and the
by-group attribution of the quantization error. The memory observatory
is left out too.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from torch.func import functional_call

from stoke_tpu_torch.configs import ServeConfig
from stoke_tpu_torch.models.bert import BERT_SIZES
from stoke_tpu_torch.models.gpt import GPT
from stoke_tpu_torch.serving.kv_cache import (
    BlockAllocator,
    PagedAttentionHook,
    PagedKVCache,
    resolve_device,
)
from stoke_tpu_torch.serving.sampling import (
    SamplingParams,
    accept_drafts,
    draw_targets,
    initial_key_data,
    sample_tokens,
    select_key_data,
    split_chain,
    split_key_data,
    validate_sampling_params,
)
from stoke_tpu_torch.serving.scheduler import Request, Scheduler
from stoke_tpu_torch.serving.telemetry import ServeMetrics
from stoke_tpu_torch.status import serve_config_error
from stoke_tpu_torch.telemetry.registry import MetricsRegistry
from stoke_tpu_torch.telemetry.tracing import (
    trace_add,
    trace_point,
    trace_span,
    tracing_active,
)

_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_LATER_OBSERVATORIES = (
    "ROADMAP Queue 1 item 10c (numerics, memory, attribution and the "
    "serving observatories: the serve SLO and cost observatories)"
)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _unsupported(cfg: ServeConfig) -> Optional[str]:
    """The first feature ``cfg`` turns on that this slice does not serve,
    with the ROADMAP item that ports it."""
    later = {
        "cost_cards": (cfg.cost_cards, _LATER_OBSERVATORIES),
        "slo_ttft_target_s": (
            cfg.slo_ttft_target_s is not None, _LATER_OBSERVATORIES
        ),
        "slo_tpot_target_s": (
            cfg.slo_tpot_target_s is not None, _LATER_OBSERVATORIES
        ),
    }
    for name, (on, item) in later.items():
        if on:
            return f"ServeConfig.{name} is not ported yet: {item}"
    return None


def _as_int32(a: np.ndarray) -> np.ndarray:
    """``a`` as int32 for the one-copy upload: integers by value, float32
    and uint32 (sampling knobs, key data) by bit pattern."""
    a = np.ascontiguousarray(a)
    if a.dtype in (np.float32, np.uint32):
        return a.view(np.int32)
    return a.astype(np.int32)


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
        # the JAX engine's own checks, then the status layer's serve rules
        if (
            cfg.prefill_chunk_tokens is not None
            and cfg.prefill_chunk_tokens % cfg.prefill_pad_multiple
        ):
            raise ValueError(
                f"prefill_chunk_tokens={cfg.prefill_chunk_tokens} must be "
                f"a multiple of prefill_pad_multiple="
                f"{cfg.prefill_pad_multiple} (the bucket discipline that "
                f"bounds compiled-program count; same rule the status "
                f"layer enforces)"
            )
        if cfg.speculative_k is not None and not cfg.sampling:
            raise ValueError(
                "ServeConfig.speculative_k needs sampling=True — the "
                "verify program rides the key-threaded sampling programs "
                "(temperature=0.0 keeps exact greedy streams); set "
                "sampling=True or drop speculative_k"
            )
        rule = serve_config_error(cfg)
        if rule is not None:
            raise ValueError(rule)
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
        #: the quantized weight store (None: the module's own weights)
        self.qparams: Optional[Dict[str, Any]] = None
        self.quant_stats: Optional[Dict[str, float]] = None
        self.quant_errors: Dict[str, Dict[str, float]] = {}
        if cfg.quant != "none":
            self._quantize(cfg)

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
            prefill_chunk_tokens=cfg.prefill_chunk_tokens,
            sampling_seed_base=cfg.sampling_seed,
        )

        self._sampling = bool(cfg.sampling)
        # the config's knobs are each request's default; greedy when
        # sampling is off
        self._default_sampling = (
            SamplingParams(temperature=cfg.temperature, top_k=cfg.top_k,
                           top_p=cfg.top_p)
            if self._sampling
            else SamplingParams()
        )
        if self._sampling:
            validate_sampling_params(self._default_sampling)
        self._chunked = cfg.prefill_chunk_tokens is not None
        self._speculative_k = cfg.speculative_k
        # a speculative engine packs every prefilling slot's chunk into one
        # dispatch, the verify batch's shape
        self._packed = self._chunked and cfg.speculative_k is not None
        if cfg.speculative_k is not None:
            self.metrics.enable_speculative()
        # per-slot key state of the sampling draws (host uint32 [B, 2], as
        # the JAX engine's), advanced once per emitted token
        self._key_data = np.zeros((cfg.max_seqs, 2), np.uint32)
        # test hook: with capture_logits set, every sampling-path draw's
        # pre-sampling logits row is kept per request id (one row per
        # emitted token)
        self.capture_logits = False
        self.captured_logits: Dict[int, List[np.ndarray]] = {}
        self._iterations = 0
        self._t_start = time.perf_counter()

    def _quantize(self, cfg: ServeConfig) -> None:
        """Quantize the weights once (the JAX engine's load-time
        quantization), record the compression and, for int8, each leaf's
        error, and free the module's storage of every tensor the store
        replaces."""
        from stoke_tpu_torch.convert import jax_param_layout
        from stoke_tpu_torch.serving.quant import (
            compression_stats,
            quantization_error,
            quantize_params,
        )

        try:
            layout = jax_param_layout(self.model)
        except ValueError:
            layout = None
        params = dict(self.model.named_parameters())
        dense = {n: p.detach() for n, p in params.items()}
        self.qparams = quantize_params(
            dense, cfg.quant, chunk_elems=cfg.quant_chunk_elems,
            stochastic=cfg.quant_stochastic, min_size=cfg.quant_min_size,
            layout=layout)
        self.quant_stats = compression_stats(dense, self.qparams)
        self.metrics.quant_compression.set(self.quant_stats["compression"])
        if cfg.quant == "int8":
            self.quant_errors = quantization_error(dense, self.qparams,
                                                   layout)
        for n, p in params.items():
            if self.qparams[n] is not dense[n]:
                p.untyped_storage().resize_(0)

    def _forward(self, *args, **kwargs):
        """The model's forward: on the module's weights, or on the
        quantized store dequantized for this dispatch."""
        if self.qparams is None:
            return self.model(*args, **kwargs)
        from stoke_tpu_torch.serving.quant import dequantize_params

        return functional_call(self.model, dequantize_params(self.qparams),
                               args, kwargs)

    # ------------------------------------------------------------------ #
    # the forwards
    # ------------------------------------------------------------------ #

    def _upload(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Copy host arrays to the device in one int32 copy (pinned and
        asynchronous on the card) and return device views of each; float32
        and uint32 arrays travel by bit pattern (see :meth:`_sampling_args`
        for their views back)."""
        flat = np.concatenate([_as_int32(a).reshape(-1) for a in arrays])
        host = torch.from_numpy(flat)
        if self.device.type == "cuda":
            host = host.pin_memory()
        buf = host.to(self.device, non_blocking=True)
        views, at = [], 0
        for a in arrays:
            views.append(buf[at : at + a.size].view(a.shape))
            at += a.size
        return views

    @staticmethod
    def _sampling_args(subs, temps, top_ks, top_ps):
        """Device views of uploaded sub keys and knobs: key data as int64
        in ``[0, 2**32)``, temperature and top-p as float32."""
        return (subs.long() & 0xFFFFFFFF, temps.view(torch.float32),
                top_ks, top_ps.view(torch.float32))

    @staticmethod
    def _draw(draw, logits, temps_host, subs, t, k, p):
        """``draw(logits, subs, t, k, p)``, or the argmax of the logits when
        no row samples (temperature 0 everywhere), which is the same
        tokens without the Gumbel noise."""
        if not np.any(temps_host > 0):
            return logits.float().argmax(dim=-1)
        return draw(logits, subs, t, k, p)

    def _knobs(self, params: SamplingParams):
        """A request's ``(temperature, top_k, top_p)`` as ``[1]`` arrays."""
        t, k, p = params.as_arrays()
        return (np.array([t], np.float32), np.array([k], np.int32),
                np.array([p], np.float32))

    def _hook(self, tables, positions, mode: str, lengths):
        return PagedAttentionHook(
            self.cache.k_pages, self.cache.v_pages, tables, positions,
            mode=mode, lengths=lengths,
            attention_impl=self.cfg.attention,
            decode_impl=self.cfg.decode_kernel,
        )

    def _capture(self, rid: int, row) -> None:
        self.captured_logits.setdefault(rid, []).append(
            np.array(row, np.float32)
        )

    def _prefill(self, padded: np.ndarray, block_row: np.ndarray,
                 prompt_len: int) -> int:
        """Greedy prefill: ``padded [1, P]`` prompt, ``block_row [1, MB]``:
        write the prompt's K/V and return the first generated token."""
        P = padded.shape[1]
        tokens, tables, plen = self._upload(
            padded, block_row, np.array([prompt_len])
        )
        positions = torch.arange(P, dtype=torch.int32, device=self.device)[None]
        hook = self._hook(tables, positions, "prefill", plen)
        logits = self._forward(tokens, positions, kv_cache=hook)
        return int(logits[0, prompt_len - 1].argmax())  # sync: the TTFT point

    def _prefill_sampling(self, padded: np.ndarray, block_row: np.ndarray,
                          prompt_len: int, slot: int, params: SamplingParams):
        """Sampling prefill: returns ``(token, advanced key data [2],
        pre-sampling logits row [V] on the device)``."""
        P = padded.shape[1]
        carry, sub = split_key_data(self._key_data[slot : slot + 1])
        knobs = self._knobs(params)
        tokens, tables, plen, *samp = self._upload(
            padded, block_row, np.array([prompt_len]), sub, *knobs
        )
        positions = torch.arange(P, dtype=torch.int32, device=self.device)[None]
        hook = self._hook(tables, positions, "prefill", plen)
        row = self._forward(tokens, positions, kv_cache=hook)[0, prompt_len - 1]
        tok = self._draw(sample_tokens, row[None], knobs[0],
                         *self._sampling_args(*samp))
        return int(tok[0]), carry[0], row  # sync: the TTFT point

    def _decode(self) -> np.ndarray:
        """One greedy decode step over all slots; returns the next tokens
        [B]."""
        tokens, positions, tables, context = self._upload(
            *self.scheduler.decode_batch()
        )
        hook = self._hook(tables, positions[:, None], "decode", context)
        logits = self._forward(
            tokens[:, None], positions[:, None], decode=True, kv_cache=hook
        )
        # sync: the tokens stream out
        return logits[:, -1, :].argmax(dim=-1).cpu().numpy()

    def _decode_sampling(self):
        """One sampling decode step over all slots: returns ``(tokens
        [B], advanced key data [B, 2], pre-sampling logits [B, V] on the
        device)``."""
        sched = self.scheduler
        carry, sub = split_key_data(self._key_data)
        knobs = sched.sampling_batch()
        tokens, positions, tables, context, *samp = self._upload(
            *sched.decode_batch(), sub, *knobs
        )
        hook = self._hook(tables, positions[:, None], "decode", context)
        logits = self._forward(
            tokens[:, None], positions[:, None], decode=True, kv_cache=hook
        )[:, -1, :]
        tok = self._draw(sample_tokens, logits, knobs[0],
                         *self._sampling_args(*samp))
        return tok.cpu().numpy(), carry, logits  # sync: tokens stream out

    def _chunk(self, toks, positions, slot: int, req: Request,
               logit_idx: int):
        """One prefill chunk of one slot: ``toks [C]`` at global
        ``positions [C]``; writes the chunk's K/V, attends the cached
        prefix and draws from row ``logit_idx`` (used by the caller only
        for the final chunk). Returns ``(token, key data [2], logits row
        [V] on the device)``."""
        sched = self.scheduler
        carry, sub = split_key_data(self._key_data[slot : slot + 1])
        knobs = self._knobs(req.params)
        tokens, pos, tables, plen, *samp = self._upload(
            toks[None], positions[None], sched.block_tables[slot : slot + 1],
            np.array([req.prompt.size]), sub, *knobs,
        )
        hook = self._hook(tables, pos, "chunk", plen)
        row = self._forward(tokens, pos, kv_cache=hook)[0, logit_idx]
        tok = self._draw(sample_tokens, row[None], knobs[0],
                         *self._sampling_args(*samp))
        # every chunk syncs, so its compute is charged to prefill and not
        # to the next decode step's fetch
        return int(tok[0]), carry[0], row

    def _packed_chunk(self, tokens, positions, tables, lengths, logit_idx,
                      rows):
        """Every prefilling slot's next chunk in one ``[B, C]`` forward;
        each row draws at its own ``logit_idx``. Returns ``(tokens [B],
        key data [B, 2], logits rows [B, V] on the device)``."""
        B = self.cfg.max_seqs
        temps = np.zeros(B, np.float32)
        ks = np.zeros(B, np.int32)
        ps = np.ones(B, np.float32)
        for i, req, _ in rows:
            temps[i], ks[i], ps[i] = req.params.as_arrays()
        carry, sub = split_key_data(self._key_data)
        toks, pos, tab, lens, idx, *samp = self._upload(
            tokens, positions, tables, lengths, logit_idx, sub, temps, ks, ps,
        )
        hook = self._hook(tab, pos, "chunk", lens)
        logits = self._forward(toks, pos, kv_cache=hook)
        V = logits.shape[-1]
        picked = torch.gather(
            logits, 1, idx.long()[:, None, None].expand(-1, 1, V)
        )[:, 0]
        tok = self._draw(sample_tokens, picked, temps,
                         *self._sampling_args(*samp))
        return tok.cpu().numpy(), carry, picked

    def _verify(self, tokens, positions, tables, lengths, draft_lens):
        """One speculative verify step: scores all S rows of every slot,
        draws the S sequential targets from each slot's key stream,
        accepts the leading exact matches, rolls the rejected rows' K/V
        back out of the pool and rewinds each key to one split per emitted
        token. Returns ``(targets [B, S], n_emit [B], key data [B, 2],
        logits [B, S, V] on the device)``."""
        sched = self.scheduler
        # the S sequential splits of every slot's stream (the JAX
        # program's scan), on the host
        key_stack, subs = split_chain(self._key_data, tokens.shape[1])
        knobs = sched.sampling_batch()
        toks, pos, tab, lens, dl, *samp = self._upload(
            tokens, positions, tables, lengths, draft_lens, subs, *knobs,
        )
        hook = self._hook(tab, pos, "verify", lens)
        logits = self._forward(toks, pos, kv_cache=hook)
        targets = self._draw(draw_targets, logits, knobs[0],
                             *self._sampling_args(*samp))
        n_emit = accept_drafts(toks[:, 1:], dl, targets)
        hook.rollback(n_emit)
        # one sync for the tokens and the acceptance counts
        host = torch.cat([targets, n_emit[:, None]], dim=1).cpu().numpy()
        targets, n_emit = host[:, :-1], host[:, -1]
        return targets, n_emit, select_key_data(key_stack, n_emit), logits

    # ------------------------------------------------------------------ #
    # request intake
    # ------------------------------------------------------------------ #

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None) -> int:
        """Enqueue one request (mid-flight is the point); returns its id.

        ``sampling`` carries the request's temperature / top-k / top-p /
        seed, validated here; it needs ``ServeConfig(sampling=True)``.
        Without it the request takes the config's knobs, and a request
        without a seed gets ``ServeConfig.sampling_seed + rid``, so a whole
        run replays from the config."""
        if sampling is not None:
            if not self._sampling:
                raise ValueError(
                    "per-request SamplingParams need ServeConfig."
                    "sampling=True (the engine picks its sampling path at "
                    "construction)"
                )
            validate_sampling_params(sampling)
            params = sampling
        else:
            params = self._default_sampling
        rid = self.scheduler.submit(prompt, max_new_tokens, eos_id,
                                    params=params)
        self.metrics.requests.inc()
        return rid

    def result(self, rid: int) -> Optional[Request]:
        return self.scheduler.finished.get(rid)

    # ------------------------------------------------------------------ #
    # the engine loop
    # ------------------------------------------------------------------ #

    def _emit_first_token(self, slot: int, req: Request, tok: int,
                          now: float) -> None:
        """The TTFT token's bookkeeping, from whole-prompt prefill or the
        final chunk."""
        m = self.metrics
        self.scheduler.note_prefill_token(slot, tok, now)
        m.tokens_out.inc()
        if not req.params.is_greedy:
            m.sampled_tokens.inc()
        m.observe_ttft(req.ttft_s)
        if req.finished:
            self._finish(req)

    def _prefill_one(self, slot: int, req: Request, padded: np.ndarray,
                     plen: int) -> None:
        sched, m = self.scheduler, self.metrics
        t0 = time.perf_counter()
        row = sched.block_tables[slot : slot + 1]
        with trace_span("serve/prefill", track="serve", request_id=req.rid,
                        attrs={"padded_len": int(padded.shape[1])}):
            if self._sampling:
                tok, key, logits = self._prefill_sampling(
                    padded, row, plen, slot, req.params)
                self._key_data[slot] = key
                if self.capture_logits:
                    self._capture(req.rid, logits.cpu())
            else:
                tok = self._prefill(padded, row, plen)
        now = time.perf_counter()
        m.prefills.inc()
        m.prefill_s.inc(now - t0)
        self._emit_first_token(slot, req, tok, now)

    def _run_chunk(self, slot: int, req: Request, toks, positions,
                   is_final: bool, logit_idx: int) -> None:
        """One chunk of one slot; only the final chunk emits the TTFT
        token and advances the request's key stream (one split per emitted
        token, as in whole-prompt prefill)."""
        sched, m = self.scheduler, self.metrics
        t0 = time.perf_counter()
        with trace_span("serve/prefill_chunk", track="serve",
                        request_id=req.rid,
                        attrs={"start": int(positions[0]),
                               "chunk": int(len(toks)),
                               "final": bool(is_final)}):
            tok, key, row = self._chunk(toks, positions, slot, req,
                                        logit_idx)
        now = time.perf_counter()
        m.prefill_chunks.inc()
        m.prefill_s.inc(now - t0)
        sched.note_chunk(slot)
        if is_final:
            self._key_data[slot] = key
            if self.capture_logits:
                self._capture(req.rid, row.cpu())
            self._emit_first_token(slot, req, tok, now)

    def _run_packed_chunks(self, tokens, positions, tables, lengths,
                           logit_idx, rows) -> None:
        """Every prefilling slot's chunk in one dispatch; final-chunk rows
        emit their TTFT tokens and take the key writeback."""
        sched, m = self.scheduler, self.metrics
        t0 = time.perf_counter()
        with trace_span("serve/prefill_chunk_packed", track="serve",
                        attrs={"packed": len(rows),
                               "chunk": int(tokens.shape[1])}):
            tok, keys, logits = self._packed_chunk(tokens, positions, tables,
                                                   lengths, logit_idx, rows)
        now = time.perf_counter()
        m.prefill_chunks.inc()  # dispatches, not serviced rows
        m.prefill_s.inc(now - t0)
        larr = logits.cpu() if self.capture_logits else None
        for i, req, is_final in rows:
            if tracing_active():
                # each request's slice of the shared packed interval,
                # whose wall clock the packed span owns once
                trace_add("serve/prefill_chunk", t0, now, track="serve",
                          request_id=req.rid, count_self=False)
            sched.note_chunk(i)
            if is_final:
                self._key_data[i] = keys[i]
                if larr is not None:
                    self._capture(req.rid, larr[i])
                self._emit_first_token(i, req, int(tok[i]), now)

    def _decode_rows(self) -> List[int]:
        """Slots in the decode batch (fully prefilled), read before the
        commit evicts any."""
        return [i for i, s in enumerate(self.scheduler.slots)
                if s.request is not None and s.prefill_pos is None]

    def _live_rids(self, rows: List[int]) -> Optional[List[int]]:
        """The decoding requests' ids while tracing, else None."""
        if not tracing_active():
            return None
        return [self.scheduler.slots[i].request.rid for i in rows]

    @staticmethod
    def _decode_slices(live_rids: Optional[List[int]], t0: float,
                       now: float) -> None:
        """Each live request's ``serve/decode`` slice of one batch step
        (``count_self=False``: the step's own span owns the interval)."""
        for rid in live_rids or ():
            trace_add("serve/decode", t0, now, track="serve",
                      request_id=rid, count_self=False)

    def _step_decode(self) -> None:
        """One decode dispatch over the slot batch."""
        sched, m = self.scheduler, self.metrics
        rows = self._decode_rows()
        live_rids = self._live_rids(rows)
        t0 = time.perf_counter()
        with trace_span("serve/decode_step", track="serve",
                        attrs={"active": sched.decoding}):
            if self._sampling:
                next_host, keys, logits = self._decode_sampling()
                # advance only the decoding slots' key streams
                for i in rows:
                    self._key_data[i] = keys[i]
                if self.capture_logits:
                    larr = logits.cpu()
                    for i in rows:
                        self._capture(sched.slots[i].request.rid, larr[i])
            else:
                next_host = self._decode()
        now = time.perf_counter()
        self._decode_slices(live_rids, t0, now)
        m.decode_steps.inc()
        m.decode_s.inc(now - t0)
        n_sampled = sum(1 for i in rows
                        if not sched.slots[i].request.params.is_greedy)
        was_finished = set(sched.finished)
        m.tokens_out.inc(sched.commit_decode(next_host, now))
        if n_sampled:
            m.sampled_tokens.inc(n_sampled)
        for rid in set(sched.finished) - was_finished:
            self._finish(sched.finished[rid])

    def _step_verify(self) -> None:
        """One speculative decode step: draft on the host, verify every
        draft in one dispatch, commit the accepted run and the correction
        or bonus token. ``decode_steps`` counts dispatches, so
        ``tokens_out / decode_steps`` is tokens per dispatch."""
        sched, m = self.scheduler, self.metrics
        rows = self._decode_rows()
        live_rids = self._live_rids(rows)
        t0 = time.perf_counter()
        with trace_span("serve/verify_step", track="serve",
                        attrs={"active": sched.decoding,
                               "k": self._speculative_k}):
            tokens, positions, tables, lengths, draft_lens = (
                sched.verify_batch(
                    self._speculative_k,
                    ngram_max=self.cfg.speculative_ngram_max,
                    ngram_min=self.cfg.speculative_ngram_min,
                ))
            targets, n_emit, keys, logits = self._verify(
                tokens, positions, tables, lengths, draft_lens
            )
            for i in rows:
                self._key_data[i] = keys[i]
            if self.capture_logits:
                larr = logits.cpu()
                for i in rows:
                    # one row per emitted token, aligned with the
                    # non-speculative engine's per-step captures
                    for j in range(int(n_emit[i])):
                        self._capture(sched.slots[i].request.rid,
                                      larr[i, j])
        now = time.perf_counter()
        self._decode_slices(live_rids, t0, now)
        m.decode_steps.inc()
        m.decode_s.inc(now - t0)
        greedy_row = {i: sched.slots[i].request.params.is_greedy
                      for i in rows}
        was_finished = set(sched.finished)
        committed, accepted = sched.commit_verify(targets, n_emit, now)
        m.tokens_out.inc(int(committed.sum()))
        m.spec_draft_tokens.inc(int(draft_lens.sum()))
        m.spec_accepted_tokens.inc(accepted)
        n_sampled = sum(int(committed[i]) for i in rows if not greedy_row[i])
        if n_sampled:
            m.sampled_tokens.inc(n_sampled)
        for rid in set(sched.finished) - was_finished:
            self._finish(sched.finished[rid])

    def step(self) -> bool:
        """One engine iteration: admit arrivals (short prompts prefill
        whole, long ones enter the chunked state), run at most one chunk
        dispatch, then one decode (or verify) dispatch over the fully
        prefilled slots. Returns True while work remains."""
        sched = self.scheduler
        with torch.inference_mode():
            for slot, req, padded, plen in sched.admit():
                if tracing_active():
                    # the request timeline's first span: arrival to
                    # admission (the queue wait, owned by other spans)
                    trace_add("serve/admission", req.arrival_ts,
                              req.admit_ts, track="serve",
                              request_id=req.rid,
                              attrs={"prompt_len": plen}, count_self=False)
                if self._sampling or self._chunked:
                    self._key_data[slot] = initial_key_data(req.seed)
                if padded is None:
                    continue  # chunked admission: chunks run below
                self._prefill_one(slot, req, padded, plen)
            if self._packed:
                nxt = sched.next_chunks()
                if nxt is not None:
                    self._run_packed_chunks(*nxt)
            elif self._chunked:
                nxt = sched.next_chunk()
                if nxt is not None:
                    self._run_chunk(*nxt)
            if sched.decoding > 0:
                if self._speculative_k is not None:
                    self._step_verify()
                else:
                    self._step_decode()
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
        # the eviction marker closes the request's trace timeline
        trace_point("serve/evict", track="serve", request_id=req.rid,
                    attrs={"tokens": len(req.tokens)})
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
