"""The plain reference of SMART-Vocoder's GAN train step (reference
``train.py:123-213``), a frozen copy in float32 over flat dicts of leaves.

In order: one generator forward (posterior, flow, prior, a random
``segment_size`` slice decoded), the jigsaw negative (4 time chunks of the
real slice permuted, ``0.75 y_hat + 0.25 y_jigsaw``, detached), the
discriminator's LSGAN loss on (real, negative) and its AdamW step, then the
generator's loss (LSGAN + feature matching + ``c_mel`` x mel L1 + ``c_kl`` x
KL) through the updated discriminator and its AdamW step. Weight-normed
convolutions hold ``weight_g`` and ``weight_v`` leaves (``w = g v / ||v||``),
as the program's nets do. Nothing here imports the program.

The randomness is the program's, worked out again: the posterior noise and
then the slice starts are drawn from a generator seeded by ``keyed_seed(seed,
step, rank)``, the permutation from ``keyed_seed(seed, step)``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import torch
import torch.nn.functional as F

from vocbench.reference import audio, graph
from vocbench.reference.graph import LRELU_SLOPE, Numerics, Param, Sizes

PERIODS = (2, 3, 5, 7, 11)
S_SPECS = ((16, 15, 1, 1, 7), (64, 41, 4, 4, 20), (256, 41, 4, 16, 20),
           (1024, 41, 4, 64, 20), (1024, 41, 4, 256, 20), (1024, 5, 1, 1, 2))
P_CHANNELS = (32, 128, 512, 1024, 1024)
WEIGHT_DECAY = 0.01  # torch.optim.AdamW's default, which train.py does not override


def keyed_seed(*key: int) -> int:
    digest = hashlib.blake2b(repr(tuple(int(k) for k in key)).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def generator_weight_norm(params: list[Param]) -> frozenset:
    """The generator modules whose weight is weight-normed in training: every
    WN layer, the upsampling convolutions and the ResBlocks."""
    normed = set()
    for q in params:
        module = q.name.rsplit(".", 1)[0]
        if q.kind == "weight" and any(part in module for part in (
                ".in_layers.", ".res_skip_layers.", ".cond_layer", "dec.ups.", "dec.resblocks.")):
            normed.add(module)
    return frozenset(normed)


def discriminator_params() -> list[Param]:
    """The discriminator ensemble's leaves (all weight-normed convolutions)."""
    out = []
    cin = 1
    for i, (ch, k, _, g, _) in enumerate(S_SPECS):
        g = math.gcd(math.gcd(g, cin), ch)
        out.append(Param(f"discriminators.0.convs.{i}.weight", (ch, cin // g, k), cin // g * k,
                         "weight"))
        out.append(Param(f"discriminators.0.convs.{i}.bias", (ch,), cin // g * k, "bias"))
        cin = ch
    out.append(Param("discriminators.0.conv_post.weight", (1, cin, 3), cin * 3, "weight"))
    out.append(Param("discriminators.0.conv_post.bias", (1,), cin * 3, "bias"))
    for d in range(1, len(PERIODS) + 1):
        cin = 1
        for i, ch in enumerate(P_CHANNELS):
            out.append(Param(f"discriminators.{d}.convs.{i}.weight", (ch, cin, 5, 1), cin * 5,
                             "weight"))
            out.append(Param(f"discriminators.{d}.convs.{i}.bias", (ch,), cin * 5, "bias"))
            cin = ch
        out.append(Param(f"discriminators.{d}.conv_post.weight", (1, cin, 3, 1), cin * 3,
                         "weight"))
        out.append(Param(f"discriminators.{d}.conv_post.bias", (1,), cin * 3, "bias"))
    return out


def discriminator_weight_norm(params: list[Param]) -> frozenset:
    return frozenset(q.name.rsplit(".", 1)[0] for q in params if q.kind == "weight")


def effective(leaves: dict) -> dict:
    """Fold each ``weight_g`` / ``weight_v`` pair into ``weight``."""
    out = {}
    for k, v in leaves.items():
        if k.endswith(".weight_g"):
            continue
        if k.endswith(".weight_v"):
            g = leaves[k[:-1] + "g"]
            norm = torch.sqrt((v * v).sum(dim=tuple(range(1, v.ndim)), keepdim=True))
            out[k[: -len("_v")]] = v * (g / norm)
        else:
            out[k] = v
    return out


# -- the discriminators --------------------------------------------------------------
def disc_s(p, x, nx: Numerics):
    fmap = []
    cin = 1
    for i, (ch, k, s, g, pad) in enumerate(S_SPECS):
        g = math.gcd(math.gcd(g, cin), ch)
        x = F.leaky_relu(graph.conv1d(p, f"discriminators.0.convs.{i}", x, nx, padding=pad,
                                      stride=s, groups=g), LRELU_SLOPE)
        fmap.append(x)
        cin = ch
    x = graph.conv1d(p, "discriminators.0.conv_post", x, nx, padding=1)
    fmap.append(x)
    return x.reshape(x.shape[0], -1), fmap


def disc_p(p, d: int, period: int, x, nx: Numerics):
    b, c, t = x.shape
    if t % period:
        x = F.pad(x, (0, period - t % period), mode="reflect")
    x = x.reshape(b, c, -1, period)
    fmap = []
    for i in range(len(P_CHANNELS)):
        x = nx.conv(F.conv2d, x, p[f"discriminators.{d}.convs.{i}.weight"],
                    p[f"discriminators.{d}.convs.{i}.bias"], stride=(3 if i < 4 else 1, 1),
                    padding=(2, 0))
        x = F.leaky_relu(x, LRELU_SLOPE)
        fmap.append(x)
    x = nx.conv(F.conv2d, x, p[f"discriminators.{d}.conv_post.weight"],
                p[f"discriminators.{d}.conv_post.bias"], padding=(1, 0))
    fmap.append(x)
    return x.reshape(b, -1), fmap


def ensemble(p, y, nx: Numerics):
    """(B, 1, samples) -> per-discriminator logits and feature maps."""
    outs = [disc_s(p, y, nx)] + [disc_p(p, d, per, y, nx)
                                 for d, per in enumerate(PERIODS, start=1)]
    return [o[0] for o in outs], [o[1] for o in outs]


# -- the step -----------------------------------------------------------------------
@dataclasses.dataclass
class StepOut:
    loss_g: float
    loss_d: float
    grads_g: dict
    grads_d: dict


def slice_rows(x, ids, size):
    """x (B, T, C) -> (B, size, C) at each row's start (clamped to [0, T - size])."""
    t = x.shape[1]
    start = ids.long().clamp(0, t - size)
    idx = start[:, None] + torch.arange(size, device=x.device)
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def train_step(pg: dict, pd: dict, opt_g, opt_d, s: Sizes, cfg: dict, spec, lengths, wav,
               seed: int, step: int, nx: Numerics = graph.F32, sid=None) -> StepOut:
    """One step on ``spec (B, T, bins)``, ``lengths (B,)``, ``wav (B, T * hop)``
    (zero beyond each row's length), updating the leaves in place."""
    tr, data = cfg["train"], cfg["data"]
    hop = int(data["hop_length"])
    seg_frames = int(tr["segment_size"]) // hop
    b, t, _ = spec.shape
    dev = spec.device
    gen = torch.Generator(device=dev).manual_seed(keyed_seed(seed, step, 0))
    eps_q = torch.randn((b, t, s.inter), generator=gen, device=dev)
    u = torch.rand((b,), generator=gen, dtype=torch.float32, device=dev)
    ids = (u * (lengths.to(dev) - seg_frames + 1).float()).int()
    perm = torch.randperm(4, generator=torch.Generator(device=dev).manual_seed(
        keyed_seed(seed, step)), device=dev)

    mel = audio.spec_to_mel(spec.float(), data)
    gp = effective(pg)
    g = graph.speaker(gp, s, sid)
    m_p, logs_p, _ = graph.mel_encoder(gp, s, mel.transpose(1, 2), lengths, nx)
    z, _, logs_q, y_mask = graph.posterior_encoder(gp, s, spec.transpose(1, 2), lengths,
                                                   eps_q.transpose(1, 2), nx, g)
    z_p = graph.flow(gp, s, z, y_mask, nx, g)
    z_slice = slice_rows(z.transpose(1, 2), ids, seg_frames).transpose(1, 2)
    y_hat = graph.decoder(gp, s, z_slice, nx, g)                       # (B, 1, seg)
    y_mel = slice_rows(mel, ids, seg_frames)
    y = slice_rows(wav[..., None], ids.long() * hop, seg_frames * hop).transpose(1, 2)
    seg = y.shape[-1]
    y_jig = y.reshape(b, 1, 4, seg // 4)[:, :, perm].reshape(b, 1, seg)
    if torch.equal(perm, torch.arange(4, device=dev)):
        y_jig = y_hat.detach()
    y_neg = 0.75 * y_hat.detach() + 0.25 * y_jig

    # the discriminator's phase
    d_params = list(pd.values())
    dp = effective(pd)
    d_r, _ = ensemble(dp, y, nx)
    d_g, _ = ensemble(dp, y_neg, nx)
    loss_d = sum(torch.mean((1 - a) ** 2) + torch.mean(c ** 2) for a, c in zip(d_r, d_g))
    grads_d = torch.autograd.grad(loss_d, d_params)
    for q, gr in zip(d_params, grads_d):
        q.grad = gr
    opt_d.step()
    opt_d.zero_grad(set_to_none=True)

    # the generator's phase, through the updated discriminator
    dp = {k: v.detach() for k, v in effective(pd).items()}
    y_hat_mel = audio.mel_spectrogram(y_hat[:, 0], data)
    _, fmap_r = ensemble(dp, y, nx)
    d_g, fmap_g = ensemble(dp, y_hat, nx)
    loss_mel = torch.mean(torch.abs(y_mel - y_hat_mel)) * float(tr["c_mel"])
    kl = logs_p - logs_q - 0.5 + 0.5 * (z_p - m_p) ** 2 * torch.exp(-2.0 * logs_p)
    loss_kl = torch.sum(kl * y_mask) / torch.sum(y_mask) * float(tr["c_kl"])
    loss_fm = 2.0 * sum(torch.mean(torch.abs(r.detach() - q))
                        for rs, qs in zip(fmap_r, fmap_g) for r, q in zip(rs, qs))
    loss_gen = sum(torch.mean((1 - q) ** 2) for q in d_g)
    loss_g = loss_gen + loss_fm + loss_mel + loss_kl
    g_params = list(pg.values())
    grads_g = torch.autograd.grad(loss_g, g_params)
    for q, gr in zip(g_params, grads_g):
        q.grad = gr
    opt_g.step()
    opt_g.zero_grad(set_to_none=True)
    return StepOut(float(loss_g.detach()), float(loss_d.detach()), dict(zip(pg, [x.detach() for x in grads_g])),
                   dict(zip(pd, [x.detach() for x in grads_d])))


def make_optimizer(cfg: dict, leaves: dict) -> torch.optim.AdamW:
    tr = cfg["train"]
    return torch.optim.AdamW(list(leaves.values()), lr=float(tr["learning_rate"]),
                             betas=(float(tr["betas"][0]), float(tr["betas"][1])),
                             eps=float(tr["eps"]), weight_decay=WEIGHT_DECAY)
