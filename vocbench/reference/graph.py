"""The plain reference of SMART-Vocoder's generator: a frozen copy of the
module graph (reference SMART-Vocoder ``models.py``, ``modules.py``) as
functions over a flat dict of tensors, in float32.

It imports nothing of the program. The parameter names are the reference's
(and so the program's) state-dict keys with every weight norm folded, so the
benchmark can hand one dict of seeded weights to both sides. Every
convolution goes through ``Numerics.conv``: ``Numerics("f32")`` is the
reference itself (float32 operands, float32 accumulation; the caller turns
TF32 off), ``Numerics("fp8")`` the control, which rounds both operands of each
convolution to float8 e4m3 with one scale a tensor before the same float32
product, as a fp8 path would; in training the gradients pass the rounding
unchanged, in float32.

Shapes are channel-first ``(B, C, T)`` inside; ``infer`` takes the mel
time-major ``(B, T, n_mels)`` as the program's API does.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1  # modules.py:17
FP8_MAX = 448.0    # largest finite float8 e4m3fn


@dataclasses.dataclass(frozen=True)
class Numerics:
    """How each convolution rounds its operands: ``f32`` (none) or ``fp8``."""

    kind: str = "f32"

    def __post_init__(self):
        if self.kind not in ("f32", "fp8"):
            raise ValueError(f"numerics {self.kind!r}: f32 or fp8")

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return x + (q - x.detach())  # the rounded value forward, a float32 gradient back

    def conv(self, fn, x, w, b, **kw):
        return fn(self.round(x.float()), self.round(w.float()), b, **kw)


F32 = Numerics("f32")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The sizes of the generator that the config states."""

    n_mels: int
    spec_channels: int
    inter: int
    hidden: int
    enc_layers: int
    flow_layers: int
    n_flows: int
    upsample_rates: tuple
    upsample_kernels: tuple
    upsample_initial: int
    res_kernels: tuple
    res_dilations: tuple
    gin: int
    n_speakers: int
    conditioned: bool
    hop: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Sizes":
        """``cfg``: the configuration as a plain dict (its JSON)."""
        m, d = cfg["model"], cfg["data"]
        if m.get("resblock", "1") != "1":
            raise ValueError("the reference holds ResBlock1 (resblock '1') only")
        n_speakers = int(d.get("n_speakers", 0))
        gin = int(m.get("gin_channels", 0))
        return cls(
            n_mels=int(d["n_mel_channels"]), spec_channels=int(d["filter_length"]) // 2 + 1,
            inter=int(m["inter_channels"]), hidden=int(m["hidden_channels"]),
            enc_layers=int(m.get("enc_layers", 16)), flow_layers=int(m.get("flow_wn_layers", 8)),
            n_flows=4, upsample_rates=tuple(m["upsample_rates"]),
            upsample_kernels=tuple(m["upsample_kernel_sizes"]),
            upsample_initial=int(m["upsample_initial_channel"]),
            res_kernels=tuple(m["resblock_kernel_sizes"]),
            res_dilations=tuple(tuple(x) for x in m["resblock_dilation_sizes"]),
            gin=gin, n_speakers=n_speakers,
            conditioned=bool(m.get("use_spk_embed", False) and n_speakers > 0 and gin > 0),
            hop=int(d["hop_length"]))


@dataclasses.dataclass(frozen=True)
class Param:
    """One leaf: its name, shape, the fan-in of torch's conv init, and what
    it is (``weight``, ``bias``, ``embedding``)."""

    name: str
    shape: tuple
    fan_in: int
    kind: str


def _conv_params(out, name, cout, cin, k, bias=True):
    out.append(Param(f"{name}.weight", (cout, cin, k), cin * k, "weight"))
    if bias:
        out.append(Param(f"{name}.bias", (cout,), cin * k, "bias"))


def _wn_params(out, name, s: Sizes, n_layers, conditioned):
    h = s.hidden
    for i in range(n_layers):
        _conv_params(out, f"{name}.in_layers.{i}", 2 * h, h, 5)
        _conv_params(out, f"{name}.res_skip_layers.{i}", 2 * h if i < n_layers - 1 else h, h, 1)
    if conditioned:
        _conv_params(out, f"{name}.cond_layer", 2 * h * n_layers, s.gin, 1)


def generator_params(s: Sizes, posterior: bool = True) -> list[Param]:
    """Every leaf of the generator, in the reference's order; the posterior
    encoder ``enc_q`` (training only) where ``posterior``."""
    out: list[Param] = []
    h, half = s.hidden, s.inter // 2
    _conv_params(out, "enc_p.pre_enc", h, s.n_mels, 1)
    _wn_params(out, "enc_p.encoder", s, s.enc_layers, False)
    _conv_params(out, "enc_p.proj", 2 * s.inter, h, 1)
    u = s.upsample_initial
    _conv_params(out, "dec.conv_pre", u, s.inter, 7)
    if s.conditioned:
        _conv_params(out, "dec.cond", u, s.gin, 1)
    j = 0
    for i, k in enumerate(s.upsample_kernels):
        ch = u // 2 ** (i + 1)
        # ConvTranspose1d weight (in, out, k); torch's fan-in is out * k
        out.append(Param(f"dec.ups.{i}.weight", (2 * ch, ch, k), ch * k, "weight"))
        out.append(Param(f"dec.ups.{i}.bias", (ch,), ch * k, "bias"))
        for rk, rd in zip(s.res_kernels, s.res_dilations):
            for n in range(len(rd)):
                _conv_params(out, f"dec.resblocks.{j}.convs1.{n}", ch, ch, rk)
            for n in range(len(rd)):
                _conv_params(out, f"dec.resblocks.{j}.convs2.{n}", ch, ch, rk)
            j += 1
    _conv_params(out, "dec.conv_post", 1, u // 2 ** len(s.upsample_kernels), 7, bias=False)
    if posterior:
        _conv_params(out, "enc_q.pre", h, s.spec_channels, 1)
        _wn_params(out, "enc_q.enc", s, s.enc_layers, s.conditioned)
        _conv_params(out, "enc_q.proj", 2 * s.inter, h, 1)
    for f in range(0, 2 * s.n_flows, 2):
        _conv_params(out, f"flow.flows.{f}.pre", h, half, 1)
        _wn_params(out, f"flow.flows.{f}.enc", s, s.flow_layers, s.conditioned)
        _conv_params(out, f"flow.flows.{f}.post", half, h, 1)
    if s.conditioned:
        out.append(Param("emb_g.weight", (s.n_speakers, s.gin), 1, "embedding"))
    return out


# -- the module graph -----------------------------------------------------------
def sequence_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B,) -> (B, 1, T) float mask."""
    return (torch.arange(t, device=lengths.device)[None, :] < lengths[:, None])[:, None].float()


def conv1d(p, name, x, nx: Numerics, padding=0, dilation=1, stride=1, groups=1):
    return nx.conv(F.conv1d, x, p[f"{name}.weight"], p.get(f"{name}.bias"), padding=padding,
                   dilation=dilation, stride=stride, groups=groups)


def wn(p, name, x, mask, n_layers, nx: Numerics, g=None):
    """WN stack (modules.py:111-184): dilation 1, kernel 5."""
    h = x.shape[1]
    out = torch.zeros_like(x)
    if g is not None:
        g = conv1d(p, f"{name}.cond_layer", g, nx)
    for i in range(n_layers):
        a = conv1d(p, f"{name}.in_layers.{i}", x, nx, padding=2)
        if g is not None:
            a = a + g[:, i * 2 * h:(i + 1) * 2 * h]
        acts = torch.tanh(a[:, :h]) * torch.sigmoid(a[:, h:])
        rs = conv1d(p, f"{name}.res_skip_layers.{i}", acts, nx)
        if i < n_layers - 1:
            x = (x + rs[:, :h]) * mask
            out = out + rs[:, h:]
        else:
            out = out + rs
    return out * mask


def mel_encoder(p, s: Sizes, mel_ct, lengths, nx: Numerics):
    """The prior network (models.py:15-47): mel (B, n_mels, T) -> m, logs, mask."""
    x = conv1d(p, "enc_p.pre_enc", mel_ct, nx)
    mask = sequence_mask(lengths, x.shape[2])
    x = wn(p, "enc_p.encoder", x * mask, mask, s.enc_layers, nx)
    stats = conv1d(p, "enc_p.proj", x, nx) * mask
    return stats[:, :s.inter], stats[:, s.inter:], mask


def posterior_encoder(p, s: Sizes, spec_ct, lengths, eps_ct, nx: Numerics, g=None):
    """models.py:83-112: z = (m + eps * exp(logs)) * mask."""
    mask = sequence_mask(lengths, spec_ct.shape[2])
    x = conv1d(p, "enc_q.pre", spec_ct, nx) * mask
    x = wn(p, "enc_q.enc", x, mask, s.enc_layers, nx, g)
    stats = conv1d(p, "enc_q.proj", x, nx) * mask
    m, logs = stats[:, :s.inter], stats[:, s.inter:]
    return (m + eps_ct * torch.exp(logs)) * mask, m, logs, mask


def coupling(p, s: Sizes, f, x, mask, nx: Numerics, g=None, reverse=False):
    """Mean-only residual coupling (modules.py:270-343)."""
    half = s.inter // 2
    x0, x1 = x[:, :half], x[:, half:]
    h = conv1d(p, f"flow.flows.{f}.pre", x0, nx) * mask
    h = wn(p, f"flow.flows.{f}.enc", h, mask, s.flow_layers, nx, g)
    m = conv1d(p, f"flow.flows.{f}.post", h, nx) * mask
    x1 = (x1 - m) * mask if reverse else (m + x1) * mask
    return torch.cat([x0, x1], dim=1)


def flow(p, s: Sizes, x, mask, nx: Numerics, g=None, reverse=False):
    """4 x (coupling, flip) (models.py:50-80); reverse undoes them in order."""
    couplings = list(range(0, 2 * s.n_flows, 2))
    if not reverse:
        for f in couplings:
            x = torch.flip(coupling(p, s, f, x, mask, nx, g), dims=(1,))
        return x
    for f in reversed(couplings):
        x = coupling(p, s, f, torch.flip(x, dims=(1,)), mask, nx, g, reverse=True)
    return x


def decoder(p, s: Sizes, z, nx: Numerics, g=None):
    """HiFi-GAN V1 (models.py:115-167): (B, inter, T) -> (B, 1, T * hop)."""
    x = conv1d(p, "dec.conv_pre", z, nx, padding=3)
    if g is not None:
        x = x + conv1d(p, "dec.cond", g, nx)
    nk = len(s.res_kernels)
    for i, (u, k) in enumerate(zip(s.upsample_rates, s.upsample_kernels)):
        x = nx.conv(F.conv_transpose1d, F.leaky_relu(x, LRELU_SLOPE), p[f"dec.ups.{i}.weight"],
                    p[f"dec.ups.{i}.bias"], stride=u, padding=(k - u) // 2)
        xs = None
        for j, (rk, rd) in enumerate(zip(s.res_kernels, s.res_dilations)):
            name = f"dec.resblocks.{i * nk + j}"
            y = x
            for n, d in enumerate(rd):
                t = conv1d(p, f"{name}.convs1.{n}", F.leaky_relu(y, LRELU_SLOPE), nx,
                           padding=(rk * d - d) // 2, dilation=d)
                t = conv1d(p, f"{name}.convs2.{n}", F.leaky_relu(t, LRELU_SLOPE), nx,
                           padding=(rk - 1) // 2)
                y = t + y
            xs = y if xs is None else xs + y
        x = xs / nk
    x = conv1d(p, "dec.conv_post", F.leaky_relu(x), nx, padding=3)  # slope 0.01 (models.py:156)
    return torch.tanh(x)


def speaker(p, s: Sizes, sid):
    """(B,) ids -> (B, gin, 1), or None for an unconditioned model."""
    if not s.conditioned or sid is None:
        return None
    return p["emb_g.weight"][sid.long()][:, :, None].float()


def infer(p, s: Sizes, mel, lengths, eps, noise_scale, sid=None, nx: Numerics = F32):
    """Synthesis (models.py:331-339): mel (B, T, n_mels), eps (B, T, inter),
    ``noise_scale`` a float or (B,) -> waveform (B, T * hop)."""
    g = speaker(p, s, sid)
    m, logs, mask = mel_encoder(p, s, mel.float().transpose(1, 2), lengths, nx)
    scale = torch.as_tensor(noise_scale, dtype=torch.float32, device=m.device)
    if scale.ndim:
        scale = scale.reshape(-1, 1, 1)
    z_p = m + eps.float().transpose(1, 2) * torch.exp(logs) * scale
    z = flow(p, s, z_p, mask, nx, g, reverse=True) * mask
    return decoder(p, s, z, nx, g)[:, 0]


def param_count(params: list[Param]) -> int:
    return sum(math.prod(q.shape) for q in params)
