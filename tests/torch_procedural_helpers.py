"""Helpers of the procedural-texture tests: inputs of every kind and a
plain mirror of the backward kernel's per-kind formulas
(solr_tpu_torch/csrc/procedural.cu ``procedural_bwd``), which the tests
hold to ``torch.autograd`` through ``textures.procedural_color_plain``
and the kernel to in turn.  No JAX here: the card's tests import it.
"""

from __future__ import annotations

import torch

from solr_tpu_torch.ops import textures as tex

KINDS = 7
# The kinds whose backward is exact: NONE (identity), MANDELBROT and JULIA
# (g * f, with uv and scale 0) and CHECKER (+-g).
EXACT_KINDS = (0, 1, 2, 3)
CASES = [str(k) for k in range(KINDS)] + ["mixed"]


def inputs(case, n, dtype=torch.float32, device="cpu", seed=5):
    """(kind, scale, uv, base_color, grad) of ``n`` rays: all of kind
    ``case`` ("0"-"6"), or "mixed": every kind with kinds -1 and 9 (the
    clamp's) among them, in runs and alone, so warps mix kinds.  uv in
    [0, 1), scale in [1, 8], base in [0.1, 0.9], as the reference test;
    grad random normal."""
    gen = torch.Generator().manual_seed(seed)
    if case == "mixed":
        kind = torch.randint(-1, KINDS + 2, (n,), generator=gen)
        kind[: n // 2] = torch.arange(n // 2).div(40, rounding_mode="floor") \
            .remainder(KINDS)
    else:
        kind = torch.full((n,), int(case))
    uv = torch.rand((n, 2), generator=gen, dtype=torch.float64)
    scale = 1.0 + 7.0 * torch.rand(n, generator=gen, dtype=torch.float64)
    base = 0.1 + 0.8 * torch.rand((n, 4), generator=gen, dtype=torch.float64)
    grad = torch.randn((n, 4), generator=gen, dtype=torch.float64)
    return tuple(x.to(device) for x in (
        kind.to(torch.int32), scale.to(dtype), uv.to(dtype), base.to(dtype),
        grad.to(dtype)))


def autograd_grads(kind, scale, uv, base, grad):
    """(grad_uv, grad_scale, grad_base) of procedural_color_plain by
    torch.autograd."""
    leaves = [x.detach().clone().requires_grad_() for x in (uv, scale, base)]
    out = tex.procedural_color_plain(kind, leaves[1], leaves[0], leaves[2])
    return torch.autograd.grad(out, leaves, grad)


def procedural_bwd_plain(kind, scale, uv, base, grad):
    """(grad_uv, grad_scale, grad_base) by the backward kernel's per-kind
    formulas, each kind computed for every ray and each ray's own taken."""
    u, v, s = uv[..., 0], uv[..., 1], scale
    k = kind.long().clamp(0, KINDS - 1)
    zero = torch.zeros_like(s)
    gf = grad[..., 0] * base[..., 0] + grad[..., 1] * base[..., 1] \
        + grad[..., 2] * base[..., 2]

    def noise_bwd(sf, g):
        qx, qy = u * sf, v * sf
        xi, yi = torch.floor(qx), torch.floor(qy)
        fx, fy = qx - xi, qy - yi
        sx = fx * fx * (3.0 - 2.0 * fx)
        sy = fy * fy * (3.0 - 2.0 * fy)
        a, b = tex._hash2(xi, yi), tex._hash2(xi + 1.0, yi)
        c, d = tex._hash2(xi, yi + 1.0), tex._hash2(xi + 1.0, yi + 1.0)
        top = a * (1 - sx) + b * sx
        bot = c * (1 - sx) + d * sx
        g_sx = g * ((b - a) * (1 - sy) + (d - c) * sy)
        g_sy = g * (bot - top)
        g_qx = g_sx * (6 * fx * (1 - fx))
        g_qy = g_sy * (6 * fy * (1 - fy))
        return g_qx * sf, g_qy * sf, g_qx * u + g_qy * v

    def turbulence_bwd(sb, g):
        gu, gv, gs = zero, zero, zero
        amp, freq = 0.5, 1.0
        for _ in range(4):
            du, dv, dsf = noise_bwd(sb * freq, g * amp)
            gu, gv, gs = gu + du, gv + dv, gs + dsf * freq
            amp *= 0.5
            freq *= 2.0
        return gu, gv, gs

    # NOISE
    noise = noise_bwd(s, gf)
    # MARBLE: 0.5 + 0.5 sin(u s 6.28318 + 4 turbulence(uv, s))
    x = u * s * 6.28318 + 4.0 * tex.turbulence(uv, s)
    g_x = gf * 0.5 * torch.cos(x)
    tu, tv, ts = turbulence_bwd(s, g_x * 4.0)
    marble = (tu + g_x * 6.28318 * s, tv, ts + g_x * 6.28318 * u)
    # GRANITE: clamp(turbulence(uv, 4 s) 1.4, 0, 1); the clamp passes its
    # edges
    xg = tex.turbulence(uv, s * 4.0) * 1.4
    g_xg = torch.where((xg >= 0.0) & (xg <= 1.0), gf, zero)
    tu, tv, ts = turbulence_bwd(s * 4.0, g_xg * 1.4)
    granite = (tu, tv, ts * 4.0)

    none = (zero, zero, zero)
    per_kind = [none, none, none, none, noise, marble, granite]
    g_uv = torch.stack([torch.stack(p[:2], -1) for p in per_kind])
    g_scale = torch.stack([p[2] for p in per_kind])

    ones = torch.ones_like(s)
    checker = torch.remainder(torch.floor(u * s) + torch.floor(v * s), 2.0)
    factors = torch.stack([
        ones, tex.mandelbrot(uv, s), tex.julia(uv, s),
        torch.where(checker > 0.5, ones, -ones), tex.value_noise(uv, s),
        0.5 + 0.5 * torch.sin(x), torch.clamp(xg, 0.0, 1.0)])
    rgb = grad[..., :3] * factors[..., None]
    g_base = torch.cat([rgb, grad[..., 3:4].expand(rgb.shape[:-1] + (1,))],
                       -1)

    def pick(t):
        idx = k.reshape((1,) + k.shape + (1,) * (t.dim() - 1 - k.dim()))
        return torch.gather(t, 0, idx.expand((1,) + t.shape[1:]))[0]

    return pick(g_uv), pick(g_scale), pick(g_base)


def assert_grads_match(got, want, kind, tol):
    """Each of (grad_uv, grad_scale, grad_base) equal to ``want`` on the
    rays of EXACT_KINDS, and on the rays of each other kind within ``tol``
    times that kind's largest entry of ``want`` (the chain rule taken in
    another association)."""
    k = kind.long().clamp(0, KINDS - 1)
    for name, g, w in zip(("uv", "scale", "base"), got, want):
        for kk in range(KINDS):
            rows = k == kk
            if not rows.any():
                continue
            a, b = g[rows], w[rows]
            if kk in EXACT_KINDS:
                assert torch.equal(a, b), (name, kk)
            else:
                err = float((a - b).abs().max())
                top = float(b.abs().max())
                assert err <= tol * top, (name, kk, err, top)
