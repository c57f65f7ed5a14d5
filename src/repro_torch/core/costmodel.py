"""Analytical stage cost model (paper Table 1/2, DESIGN.md §2) + hardware
profiles.

Per-stage FLOPs and memory traffic for encode / prefill / decode, evaluated
against a roofline ``T = max(T_comp, T_mem)`` (paper §3.1, [39]).  The model
drives (a) the discrete-event simulator's batch execution times (DESIGN.md
§3), (b) the budget binary search of Algorithm 1 (DESIGN.md §6), (c) the
Fig-5/Fig-6 benchmarks, and (d) the autotuner's goodput upper bounds
(DESIGN.md §7).

The paper's key "multi-stream" observation falls out naturally: for a batch
that mixes encode work (compute-leaning) and decode work (memory-bound),

  sequential:  T = max(Ce, Me) + max(Cd, Md)
  parallel:    T = max(Ce + Cd, Me + Md)        (two streams / fused step)

so parallel execution hides the idle side of each roofline.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.configs.base import (ATTN_MLP, ATTN_MOE, MLA_MLP, MLA_MOE, MAMBA1,
                                MAMBA2, SHARED_ATTN, ModelConfig)


# ---------------------------------------------------------------------------
# hardware
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # dense bf16/fp16 FLOP/s per chip
    hbm_bw: float              # B/s per chip
    link_bw: float             # B/s inter-chip (migration path)
    mem_bytes: float           # HBM capacity per chip
    mfu: float = 0.60          # achievable fraction of peak flops
    mbu: float = 0.80          # achievable fraction of peak bandwidth
    kernel_overhead: float = 40e-6  # per-op launch/dispatch overhead (s)
    # serving calibration: real engines see distinct efficiencies per stage
    # (ViT encode is small-matmul-bound; decode is bandwidth-bound) plus a
    # per-iteration scheduler/launch overhead (Python + ~1e2 kernels).
    encode_mfu: float = 0.20
    prefill_mfu: float = 0.55
    serve_mbu: float = 0.60
    iter_overhead: float = 2.5e-3


H800 = Hardware("H800", peak_flops=989e12, hbm_bw=3.35e12, link_bw=400e9,
                mem_bytes=80e9)
A100 = Hardware("A100", peak_flops=312e12, hbm_bw=2.04e12, link_bw=300e9,
                mem_bytes=80e9)
L40S = Hardware("L40S", peak_flops=362e12, hbm_bw=864e9, link_bw=64e9,
                mem_bytes=48e9)
TPU_V5E = Hardware("TPUv5e", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9,
                   mem_bytes=16e9, iter_overhead=1.5e-3)
CPU_SIM = Hardware("CPUsim", peak_flops=200e9, hbm_bw=20e9, link_bw=10e9,
                   mem_bytes=8e9, kernel_overhead=1e-3, iter_overhead=20e-3)

HARDWARE = {"h800": H800, "a100": A100, "l40s": L40S, "v5e": TPU_V5E,
            "cpu": CPU_SIM}

BYTES = 2  # fp16/bf16 (paper: all weights/caches fp16)


# ---------------------------------------------------------------------------
# per-model static quantities
# ---------------------------------------------------------------------------
def _attn_like(kind) -> bool:
    return kind in (ATTN_MLP, ATTN_MOE, MLA_MLP, MLA_MOE, SHARED_ATTN)


def param_count(cfg: ModelConfig) -> int:
    """Total parameters (weights actually stored)."""
    d, H, Kh, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    shared_counted = False
    for kind in cfg.layer_kinds():
        if kind in (ATTN_MLP, ATTN_MOE):
            total += d * (H * Dh) * 2 + d * (Kh * Dh) * 2
            if cfg.cross_attention:
                total += d * (H * Dh) * 2 + d * (Kh * Dh) * 2
        elif kind in (MLA_MLP, MLA_MOE):
            ql = cfg.q_lora_rank or d
            total += d * ql + ql * H * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
            total += d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
            total += cfg.kv_lora_rank * H * (cfg.qk_nope_head_dim + cfg.v_head_dim)
            total += H * cfg.v_head_dim * d
        elif kind in (MAMBA1,):
            di = cfg.d_inner
            total += d * 2 * di + di * (cfg.dt_rank + 2 * cfg.ssm_state)
            total += cfg.dt_rank * di + di * cfg.ssm_state + di * d
        elif kind == MAMBA2:
            di = cfg.d_inner
            total += d * 2 * di + d * 2 * cfg.ssm_state + di * d
        elif kind == SHARED_ATTN and not shared_counted:
            total += d * (H * Dh) * 2 + d * (Kh * Dh) * 2 + 3 * d * cfg.d_ff
            shared_counted = True
        # FFN
        if kind in (ATTN_MLP, MLA_MLP):
            n_mats = 2 if cfg.act == "gelu_mlp" else 3
            total += n_mats * d * cfg.d_ff
        elif kind in (ATTN_MOE, MLA_MOE):
            ff = cfg.moe_d_ff or cfg.d_ff
            total += d * cfg.num_experts + 3 * cfg.num_experts * d * ff
            total += 3 * d * ff * cfg.num_shared_experts
    if cfg.encoder_layers:
        total += cfg.encoder_layers * (4 * d * d + 2 * d * cfg.d_ff)
    if cfg.frontend == "vision":
        total += 4 * cfg.d_model ** 2  # projector
        total += cfg.vision_layers * 12 * cfg.vision_d_model ** 2  # tower (stub)
    return int(total)


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: only routed top-k experts)."""
    if not cfg.num_experts:
        return param_count(cfg)
    d = cfg.d_model
    ff = cfg.moe_d_ff or cfg.d_ff
    total = param_count(cfg)
    n_moe = sum(1 for k in cfg.layer_kinds() if k in (ATTN_MOE, MLA_MOE))
    total -= 3 * n_moe * d * ff * (cfg.num_experts - cfg.experts_per_token)
    return int(total)


def kv_bytes_per_token(cfg: ModelConfig) -> int:
    """KV-cache bytes per context token (all layers)."""
    total = 0
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind in (MLA_MLP, MLA_MOE):
            total += (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * BYTES
        elif _attn_like(kind):
            total += 2 * cfg.num_kv_heads * cfg.head_dim * BYTES
    return total


def ssm_state_bytes(cfg: ModelConfig, batch: int = 1) -> int:
    """Fixed-size recurrent state bytes per request (SSM/hybrid)."""
    total = 0
    for kind in cfg.layer_kinds():
        if kind == MAMBA1:
            total += cfg.d_inner * cfg.ssm_state * 4
            total += (cfg.conv_kernel - 1) * cfg.d_inner * BYTES
        elif kind == MAMBA2:
            total += cfg.d_inner * cfg.ssm_state * 4
            total += (cfg.conv_kernel - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * BYTES
    return total * batch


def image_cache_bytes(cfg: ModelConfig, n_images: int = 1) -> int:
    """Image-token cache bytes per image (paper: 1-layer single-token cache)."""
    return n_images * cfg.media_tokens * cfg.d_model * BYTES


# ---------------------------------------------------------------------------
# stage FLOPs / memory traffic (paper Table 2, generalized per layer kind)
# ---------------------------------------------------------------------------
def _dense_layer_cost(d, h_q, h_kv, ff, n_tokens, context, batch, n_mats):
    """One attn+mlp layer: (flops, bytes).  n_tokens = new tokens in batch;
    context = average context length attended to (per request)."""
    # projections: q, o are d*h_q; k, v are d*h_kv; ff mats
    proj_w = 2 * d * h_q + 2 * d * h_kv + n_mats * d * ff
    flops = 2 * n_tokens * proj_w
    # attention score+value flops: tokens x context x (h_q dims) x 2 matmuls
    flops += 4 * n_tokens * context * h_q
    bytes_ = proj_w * BYTES                      # weights
    bytes_ += 2 * n_tokens * d * BYTES           # activations in/out (approx)
    bytes_ += 2 * batch * context * h_kv * BYTES  # KV read
    return flops, bytes_


def stage_cost(cfg: ModelConfig, stage: str, *, n_tokens: int = 0,
               batch: int = 1, context: int = 0, n_images: int = 0):
    """(flops, bytes) for one batch iteration of a stage.

    encode: n_images media items through the frontend (+projector).
    prefill: n_tokens new prompt tokens (sum over requests), avg ``context``.
    decode: batch requests x 1 token, avg ``context`` each.
    """
    d = cfg.d_model
    if stage == "encode":
        flops = bytes_ = 0.0
        T = cfg.media_tokens
        if cfg.frontend == "audio" or cfg.encoder_layers:
            L, dd, ff = cfg.encoder_layers, d, cfg.d_ff
            for _ in range(L):
                f, b = _dense_layer_cost(dd, dd, dd, ff, n_images * T, T, n_images, 2)
                flops += f
                bytes_ += b
        else:
            vd = cfg.vision_d_model or d
            for _ in range(cfg.vision_layers or 24):
                f, b = _dense_layer_cost(vd, vd, vd, 4 * vd, n_images * T, T,
                                         n_images, 2)
                flops += f
                bytes_ += b
            # projector
            flops += 2 * n_images * T * 4 * d * d
            bytes_ += 4 * d * d * BYTES + 2 * n_images * T * d * BYTES
        return flops, bytes_

    if stage == "decode":
        n_tokens = batch
    if context == 0:
        context = max(1, n_tokens // max(batch, 1))

    flops = bytes_ = 0.0
    h_q = cfg.num_heads * cfg.head_dim
    h_kv = cfg.num_kv_heads * cfg.head_dim
    n_mats = 2 if cfg.act == "gelu_mlp" else 3
    for kind in cfg.layer_kinds():
        if kind in (ATTN_MLP, SHARED_ATTN):
            f, b = _dense_layer_cost(d, h_q, h_kv, cfg.d_ff, n_tokens, context,
                                     batch, n_mats)
        elif kind == ATTN_MOE:
            ff = cfg.moe_d_ff or cfg.d_ff
            f, b = _dense_layer_cost(d, h_q, h_kv, 0, n_tokens, context, batch, 0)
            k_act = cfg.experts_per_token + cfg.num_shared_experts
            f += 2 * n_tokens * 3 * d * ff * k_act
            # decode touches up to min(E, batch*k) expert weight sets
            touched = min(cfg.num_experts, max(1, n_tokens) * cfg.experts_per_token)
            b += 3 * d * ff * touched * BYTES
        elif kind in (MLA_MLP, MLA_MOE):
            ql = cfg.q_lora_rank or d
            qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            H = cfg.num_heads
            R = cfg.kv_lora_rank
            proj_w = d * ql + ql * H * qk + d * (R + cfg.qk_rope_head_dim) \
                + R * H * (cfg.qk_nope_head_dim + cfg.v_head_dim) \
                + H * cfg.v_head_dim * d
            f = 2 * n_tokens * proj_w
            f += 4 * n_tokens * context * H * (R + cfg.qk_rope_head_dim) \
                if stage == "decode" else 4 * n_tokens * context * H * qk
            b = proj_w * BYTES + 2 * n_tokens * d * BYTES
            b += batch * context * (R + cfg.qk_rope_head_dim) * BYTES
            if kind == MLA_MOE:
                ff = cfg.moe_d_ff or cfg.d_ff
                k_act = cfg.experts_per_token + cfg.num_shared_experts
                f += 2 * n_tokens * 3 * d * ff * k_act
                touched = min(cfg.num_experts,
                              max(1, n_tokens) * cfg.experts_per_token)
                b += 3 * d * ff * touched * BYTES
            else:
                f += 2 * n_tokens * 3 * d * cfg.d_ff
                b += 3 * d * cfg.d_ff * BYTES
        elif kind in (MAMBA1, MAMBA2):
            di = cfg.d_inner
            N = cfg.ssm_state
            w = 2 * d * di + di * d
            if kind == MAMBA1:
                w += di * (cfg.dt_rank + 2 * N) + cfg.dt_rank * di
            f = 2 * n_tokens * w + 10 * n_tokens * di * N  # scan elementwise
            b = w * BYTES + 2 * n_tokens * d * BYTES + batch * di * N * 4
        else:
            raise ValueError(kind)
        flops += f
        bytes_ += b
    # embedding + head
    flops += 2 * n_tokens * d * cfg.vocab_size
    bytes_ += cfg.vocab_size * d * BYTES
    return flops, bytes_


# ---------------------------------------------------------------------------
# roofline execution time
# ---------------------------------------------------------------------------
def roofline_time(hw: Hardware, flops: float, bytes_: float) -> float:
    if flops == 0 and bytes_ == 0:
        return 0.0
    return max(flops / (hw.peak_flops * hw.mfu),
               bytes_ / (hw.hbm_bw * hw.mbu)) + hw.kernel_overhead


@dataclass
class BatchWork:
    """Composition of one batch iteration (the unit Algorithm 1 builds)."""
    decode_batch: int = 0
    decode_context: int = 0          # average context length of decodes
    prefill_tokens: int = 0          # chunked-prefill tokens this iteration
    prefill_context: int = 0         # avg context (incl. already-done chunks)
    prefill_batch: int = 0
    encode_images: int = 0


def batch_time(cfg: ModelConfig, hw: Hardware, work: BatchWork, *,
               parallel_streams: bool = True, tp: int = 1) -> float:
    """Execution time of one mixed batch on one instance (tp-way sharded).

    Language work (prefill+decode) is operator-fused into one pass (paper:
    flattened tokens + offset metadata); encode runs in the second stream.
    """
    lf = lb = 0.0
    if work.decode_batch:
        f, b = stage_cost(cfg, "decode", batch=work.decode_batch,
                          context=max(1, work.decode_context))
        lf += f
        lb += b
    if work.prefill_tokens:
        f, b = stage_cost(cfg, "prefill", n_tokens=work.prefill_tokens,
                          batch=max(1, work.prefill_batch),
                          context=max(1, work.prefill_context))
        lf += f
        lb += b
    ef = eb = 0.0
    if work.encode_images:
        ef, eb = stage_cost(cfg, "encode", n_images=work.encode_images)
    ef, eb, lf, lb = ef / tp, eb / tp, lf / tp, lb / tp
    if not (ef or lf):
        return 0.0
    lang_mfu = hw.prefill_mfu
    if parallel_streams:
        t = max(ef / (hw.peak_flops * hw.encode_mfu)
                + lf / (hw.peak_flops * lang_mfu),
                (eb + lb) / (hw.hbm_bw * hw.serve_mbu))
        return t + hw.iter_overhead
    t = 0.0
    if lf:
        t += max(lf / (hw.peak_flops * lang_mfu),
                 lb / (hw.hbm_bw * hw.serve_mbu))
    if ef:
        t += max(ef / (hw.peak_flops * hw.encode_mfu),
                 eb / (hw.hbm_bw * hw.serve_mbu))
    return t + hw.iter_overhead


def migration_time(hw: Hardware, bytes_: float, rtt: float = 0.5e-3) -> float:
    """Pull-based cache migration: control RTT + asynchronous bulk transfer."""
    return rtt + bytes_ / hw.link_bw


@dataclass(frozen=True)
class CacheFeedback:
    """Measured prefix/encode cache effectiveness, fed back into the
    autotuner's workload model (DESIGN.md §14).

    A prefix hit removes prefill *compute* for the matched tokens and an
    encode hit removes the whole encode pass — but neither shrinks the
    decode-time attention context: adopted pages are still read every
    decode step.  So only ``prefill_tokens`` and ``images`` are
    discounted; ``decode_context`` must stay at the full value.

    Build one from ``HydraServer.cache_stats()`` /
    ``Engine.cache_stats()``:

        fb = CacheFeedback.from_stats(engine.cache_stats())
        autotune_disaggregation(cfg, hw, profile, slo, cache=fb)
    """
    prefix_hit_rate: float = 0.0     # fraction of prompt tokens adopted
    encode_hit_rate: float = 0.0     # fraction of images skipping encode

    def effective_prefill(self, tokens: float) -> float:
        return tokens * (1.0 - min(max(self.prefix_hit_rate, 0.0), 1.0))

    def effective_images(self, images: float) -> float:
        return images * (1.0 - min(max(self.encode_hit_rate, 0.0), 1.0))

    @classmethod
    def from_stats(cls, stats: dict) -> "CacheFeedback":
        return cls(prefix_hit_rate=float(stats.get("prefix_hit_rate", 0.0)),
                   encode_hit_rate=float(stats.get("encode_hit_rate", 0.0)))
