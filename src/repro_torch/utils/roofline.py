"""Roofline terms from an op count, at one NVIDIA H100's published rates.

Port of ``repro.utils.roofline``, with the H100 SXM data sheet (dense
rates, no sparsity; at the full 700 W power limit) in place of TPU v5e's:

    compute term    = sum over rates of FLOPs at that rate / the rate
    memory term     = HBM bytes per device / 3.35 TB/s
    collective term = wire bytes per device / 450 GB/s (NVLink, one direction)

The reference divides every FLOP by one bf16 peak. Here each FLOP is
counted under the rate of the unit that runs it (``utils.opcount``):
``bf16`` tensor-core products, ``tf32`` tensor-core products of f32 inputs
(where TF32 is allowed, and the f32 flash kernel's 3xTF32 products),
``f32`` and ``f64`` products and elementwise work outside the tensor
cores. The counts are per device, so the terms are too.
``model_flops_estimate`` is the reference's arithmetic: 6 N D (train) or
2 N D (inference) on the active parameters, plus attention and SSD terms;
its ratio to the counted FLOPs shows recompute and masked-block waste.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, per card
PEAK_FLOPS_BY_DTYPE = {
    "bf16": 989e12,  # H100: bf16 / fp16 tensor cores
    "tf32": 495e12,  # H100: TF32 tensor cores
    "f32": 67e12,  # H100: fp32 outside the tensor cores
    "f64": 34e12,  # H100: fp64 outside the tensor cores
}
PEAK_FLOPS = PEAK_FLOPS_BY_DTYPE["bf16"]  # H100: the peak an MFU is quoted against
HBM_BW = 3.35e12  # H100: HBM3 bytes/s
NVLINK_BW = 450e9  # H100: NVLink bytes/s, one direction

__all__ = [
    "static_cost_terms",
    "roofline_terms",
    "model_flops_estimate",
    "PEAK_FLOPS",
    "PEAK_FLOPS_BY_DTYPE",
    "HBM_BW",
    "NVLINK_BW",
]


def static_cost_terms(flops_by_dtype: dict, hbm_bytes: float, wire_bytes: float) -> dict:
    """Roofline seconds and the bottleneck of raw counts: FLOPs keyed by rate
    (a key of ``PEAK_FLOPS_BY_DTYPE``), HBM bytes, collective wire bytes."""
    unknown = set(flops_by_dtype) - set(PEAK_FLOPS_BY_DTYPE)
    if unknown:
        raise ValueError(f"static_cost_terms: FLOPs at unknown rates {sorted(unknown)}; known: "
                         f"{sorted(PEAK_FLOPS_BY_DTYPE)}")
    terms = {
        "compute_s": sum(f / PEAK_FLOPS_BY_DTYPE[r] for r, f in flops_by_dtype.items()),
        "memory_s": hbm_bytes / HBM_BW,
        "collective_s": wire_bytes / NVLINK_BW,
    }
    bottleneck = max(terms, key=terms.get)
    return {**terms, "bottleneck": bottleneck.replace("_s", ""), "step_time_lb_s": max(terms.values())}


def roofline_terms(report, n_devices: int, model_flops: float | None = None) -> dict:
    """``static_cost_terms`` of a per-device count (an ``opcount.OpReport``),
    and with ``model_flops`` (global, a step) the useful-compute ratio
    (model FLOPs over the counted FLOPs of every device) and the MFU bound
    (model FLOPs over the step's lower bound times the devices' bf16 peak)."""
    out = static_cost_terms(report.flops_by_dtype, report.hbm_bytes, report.collective_wire_bytes)
    if model_flops is not None and report.flops > 0:
        out["model_flops_ratio"] = model_flops / (report.flops * n_devices)
        out["mfu_upper_bound"] = model_flops / (out["step_time_lb_s"] * n_devices * PEAK_FLOPS)
    return out


def model_flops_estimate(cfg, cell) -> dict:
    """Analytic MODEL_FLOPS for this (arch x shape) cell (global, per step)."""
    B, S = cell.global_batch, cell.seq_len
    train = cell.step == "train"
    n_tokens = B * (S if cell.step != "decode" else 1)
    mult = 6 if train else 2
    n_active = cfg.n_active_params()
    dense = mult * n_active * n_tokens

    # attention score/value flops: 2 * 2 * B * S_q * S_kv_eff * H * dh per layer
    attn = 0.0
    n_attn = sum(1 for k in cfg.pattern() if k == "attn")
    H, dh = cfg.n_heads, cfg.d_head
    if cell.step == "decode":
        kv = min(S, cfg.sliding_window or S)
        attn = 4.0 * B * 1 * kv * H * dh * n_attn
    else:
        kv_eff = min(S, cfg.sliding_window or S)
        # causal: ~half the square (full square for encoders)
        frac = 1.0 if not cfg.causal else 0.5
        attn = 4.0 * B * S * kv_eff * frac * H * dh * n_attn
        if train:
            attn *= 3  # fwd + 2x bwd
    # SSD state flops: ~ (2*N*P*2) per token per head (state update + output)
    ssd = 0.0
    if cfg.ssm is not None:
        Hs = cfg.ssm.n_heads(cfg.d_model)
        n_ssm = sum(1 for k in cfg.pattern() if k == "ssm")
        ssd = 4.0 * n_tokens * Hs * cfg.ssm.d_state * cfg.ssm.head_dim * n_ssm
        if train:
            ssd *= 3
    total = dense + attn + ssd
    return {"dense": dense, "attn": attn, "ssd": ssd, "total": total}
