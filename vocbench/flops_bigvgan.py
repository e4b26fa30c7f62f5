"""Model FLOPs of BigVGAN-v2's generator, and the work and bytes of its
anti-aliased SnakeBeta activations, over the configuration's JSON.

Model FLOPs are the algorithmic conv work (2 x MACs) walked from the config:
``conv_pre``, each stage's transposed conv (``2 T_in K Cin Cout``), its AMP
blocks' convolutions (two a residual pair, three pairs a kernel size) and
``conv_post``, not what an implementation executes. The activations' own
filtering is not model FLOPs; it is counted apart, once for whatever
implements it: per input element 24 FLOPs of the up filter (two outputs of
six taps, multiply and add), 24 of the down filter (twelve taps), and five
SnakeBeta operations (multiply, sine, square, multiply-add) on each of the two
upsampled elements; bytes are one read of the input and one write of the
output at the port's storage types: the residual stream f32, a conv's output
and every activation's output bf16.
"""

from __future__ import annotations

H100_F32_PEAK = 67e12  # FLOP/s, f32 outside the tensor cores (H100 SXM data sheet)

UP_FLOPS = 24      # per input element
DOWN_FLOPS = 24    # per input (= output) element
SNAKE_FLOPS = 5    # per upsampled element, the sine counted as one


def _conv(t_out: float, cin: int, cout: int, k: int) -> float:
    return 2.0 * t_out * cout * cin * k


def stages(cfg: dict, frames: float):
    """``(channels, samples)`` of each stage's activations for ``frames``
    mel frames."""
    m = cfg["model"]
    t, out = float(frames), []
    for i, u in enumerate(m["upsample_rates"]):
        t *= u
        out.append((m["upsample_initial_channel"] // 2 ** (i + 1), t))
    return out


def generator_flops(cfg: dict, frames: float) -> float:
    m, d = cfg["model"], cfg["data"]
    c0 = m["upsample_initial_channel"]
    fl = _conv(frames, d["n_mel_channels"], c0, 7)
    t_in, c_in = float(frames), c0
    for (ch, t), k in zip(stages(cfg, frames), m["upsample_kernel_sizes"]):
        fl += 2.0 * t_in * k * c_in * ch
        for rk, rd in zip(m["resblock_kernel_sizes"], m["resblock_dilation_sizes"]):
            fl += 2 * len(rd) * _conv(t, ch, ch, rk)
        t_in, c_in = t, ch
    return fl + _conv(t_in, c_in, 1, 7)


def aa_activations(cfg: dict, rows: int, frames: float) -> tuple[float, float, int]:
    """FLOPs, bytes and launches of a call's activations over ``rows`` rows
    of ``frames`` frames (the padded bucket a call launches on)."""
    m = cfg["model"]
    store, resid = 2, 4  # bf16 operands and outputs, the f32 residual stream
    per_elem = UP_FLOPS + DOWN_FLOPS + 2 * SNAKE_FLOPS
    fl = by = 0.0
    n = 0
    pairs = sum(len(rd) for rd in m["resblock_dilation_sizes"])
    for ch, t in stages(cfg, frames):
        elems = rows * ch * t
        # A1 reads the residual stream, A2 a conv's output; both write a conv's operand
        fl += 2 * pairs * per_elem * elems
        by += pairs * elems * ((resid + store) + (store + store))
        n += 2 * pairs
    ch, t = stages(cfg, frames)[-1]
    fl += per_elem * rows * ch * t
    by += rows * ch * t * (resid + store)
    return fl, by, n + 1


def roofline_seconds(flops: float, nbytes: float) -> float:
    from vocbench.flops import H100_HBM_BYTES_S

    return max(flops / H100_F32_PEAK, nbytes / H100_HBM_BYTES_S)
