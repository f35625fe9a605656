"""State-space mixers: Mamba1 (falcon-mamba) and Mamba2/SSD (zamba2).

The port of ``repro/models/ssm.py``, in plain PyTorch.  Both mixers run
the reference's **chunked scan**: a loop over sequence chunks carrying the
SSM state, with a parallel scan inside each chunk.  The per-timestep state
tensor (B, d_inner, N) is materialized only within one chunk, so activation
memory is O(chunk * d_inner * N) rather than O(S * d_inner * N).

Inside a Mamba1 chunk the reference runs ``lax.associative_scan``; the port
runs a log-depth doubling scan (Hillis-Steele: log2(chunk) rounds of the
same combine), so a chunk costs a few launches a round instead of one per
time step.  The combine is associated in another order than XLA's, so the
results agree with the reference's within float32 rounding, not bitwise.

Both mixers expose:
  * ``*_forward``  — full-sequence training/prefill path (its chunk loop
    is ``*_scan``);
  * ``*_step``     — single-token decode with explicit carried state
    (O(1) per token).

Both take ``tp`` (``launch.sharding.TensorParallel``, None on one
device): a rank then runs its channels of mamba1 (``d_inner`` split) or
its heads of mamba2, with B and C computed on every rank, and returns a
partial sum of the out-projection.  ``in_proj`` concatenates the parts
([x | z], [z | x | B | C | dt]), so the block a rank stores is not its
slice and the layer all-gathers it (:func:`mamba1_local`,
:func:`mamba2_local`).  x_proj's partial dt, B and C and mamba2's norm
sum over the model group.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C), w: (C, K) -> (B, S, C); float32
    sums over the K taps in the reference's order."""
    k, s = w.shape[-1], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + pad[:, j:j + s, :].float() * w[:, j].float()
    return out.to(x.dtype)


def conv_step(x_new: torch.Tensor, conv_state: torch.Tensor,
              w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode-time depthwise conv: x_new (B, C), conv_state (B, K-1, C).
    Returns (out (B, C), the new state (B, K-1, C))."""
    k = w.shape[-1]
    window = torch.cat([conv_state, x_new[:, None, :]], dim=1)
    out = torch.einsum("bkc,ck->bc", window.float(),
                       w.float()).to(x_new.dtype)
    return out, window[:, 1:k, :]


def _doubling_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along axis 1 with the
    reference's combine ((a, b) then (a', b') -> (a a', b a' + b')): after
    the rounds, (a_t, b_t) map the state before step 0 to the state after
    step t.  Out of place, so autograd sees every round."""
    n, k = a.shape[1], 1
    while k < n:
        b = torch.cat([b[:, :k], torch.addcmul(b[:, k:], a[:, k:],
                                               b[:, :-k])], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return a, b


# ---------------------------------------------------------------------------
# Mamba1 (selective SSM) — falcon-mamba-7b
# params (per layer): in_proj (d, 2*di), conv (di, K), x_proj
# (di, dt_rank + 2*state), dt_proj (dt_rank, di) + dt_bias (di,),
# A_log (di, state), D (di,), out_proj (di, d)
# ---------------------------------------------------------------------------

class MambaState(NamedTuple):
    conv: torch.Tensor      # (B, K-1, di)
    ssm: torch.Tensor       # (B, di, state)


def mamba1_local(p: dict, tp) -> dict:
    """The weights of this rank's channels of a mamba1 layer."""
    di = tp.cfg.d_inner
    c = [tp.split(di)]
    (c0, c1), = c
    out = {"in_proj": tp.take(p, "in_proj", 1,
                              [(c0, c1), (di + c0, di + c1)]),
           "dt_proj": tp.take(p, "dt_proj", 1, c)}
    for name in ("conv", "x_proj", "dt_bias", "A_log", "D", "out_proj"):
        out[name] = tp.take(p, name, 0, c)
    return out


def _mamba1_select(p: dict, x: torch.Tensor, state: int, tp=None):
    """dt, B and C of the conv's output x, and the decay rates a; under
    ``tp`` x_proj's partial sums are summed over the model group."""
    dt_rank = p["dt_proj"].shape[0]
    xdbl = x @ p["x_proj"]
    if tp is not None:
        xdbl = tp.sum_inside(xdbl)
    dt, bmat, cmat = xdbl.split([dt_rank, state, state], -1)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
    a = -torch.exp(p["A_log"].float())                   # (di, N)
    return dt, bmat, cmat, a


def mamba1_scan(dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                x: torch.Tensor, a: torch.Tensor, chunk: int) -> torch.Tensor:
    """The selective scan h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t,
    y_t = C_t . h_t from a zero state, chunk by chunk: dt, x (B, S, di),
    B, C (B, S, N), a (di, N) -> y (B, S, di) float32."""
    bsz, s, di = x.shape
    chunk = min(chunk, s)
    assert s % chunk == 0
    h = torch.zeros((bsz, di, a.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for i in range(0, s, chunk):
        dt_i, b_i, c_i, x_i = (t[:, i:i + chunk]
                               for t in (dt, bmat, cmat, x))
        decay = torch.exp(dt_i[..., None].float() * a)   # (B, C, di, N)
        drive = (dt_i[..., None] * b_i[:, :, None, :] *
                 x_i[..., None]).float()
        aa, bb = _doubling_scan(decay, drive)
        h_all = aa * h[:, None] + bb
        ys.append(torch.einsum("bsdn,bsn->bsd", h_all, c_i.float()))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1)


def mamba1_forward(p: dict, u: torch.Tensor, *, state: int,
                   chunk: int = 256, unroll: bool = False,
                   tp=None) -> torch.Tensor:
    """u: (B, S, d) -> (B, S, d).  ``unroll`` is the reference's compile
    switch and has no effect here."""
    if tp is not None:
        p, u = mamba1_local(p, tp), tp.enter(u)
    x, z = (u @ p["in_proj"]).chunk(2, dim=-1)           # (B, S, di)
    x = F.silu(causal_conv1d(x, p["conv"]))
    dt, bmat, cmat, a = _mamba1_select(p, x, state, tp)
    y = mamba1_scan(dt, bmat, cmat, x, a, chunk).to(u.dtype)
    y = y + x * p["D"].to(x.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"]


def mamba1_step(p: dict, u_t: torch.Tensor, st: MambaState, *, state: int,
                tp=None) -> tuple[torch.Tensor, MambaState]:
    """u_t: (B, d) one token -> (y_t, new state). O(1) in sequence length.
    Under ``tp`` the state holds the rank's channels."""
    if tp is not None:
        p = mamba1_local(p, tp)
    x, z = (u_t @ p["in_proj"]).chunk(2, dim=-1)         # (B, di)
    x, conv_new = conv_step(x, st.conv, p["conv"])
    x = F.silu(x)
    dt, bmat, cmat, a = _mamba1_select(p, x, state, tp)
    decay = torch.exp(dt[..., None].float() * a)         # (B, di, N)
    drive = (dt[..., None] * bmat[:, None, :] * x[..., None]).float()
    h = decay * st.ssm + drive
    y = torch.einsum("bdn,bn->bd", h, cmat.float()).to(u_t.dtype)
    y = y + x * p["D"].to(x.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"], MambaState(conv_new, h)


# ---------------------------------------------------------------------------
# Mamba2 (SSD, scalar decay per head) — zamba2
# params: in_proj (d, 2*di + 2*state + nh), conv ((di + 2*state), K),
# A_log (nh,), D (nh,), dt_bias (nh,), norm_scale (di,), out_proj (di, d)
# ---------------------------------------------------------------------------

class Mamba2State(NamedTuple):
    conv: torch.Tensor      # (B, K-1, di + 2N)
    ssm: torch.Tensor       # (B, nh, hd, N)


def _mamba2_ranges(tp) -> tuple:
    """This rank's heads [n0, n1) and their channels [c0, c1)."""
    n0, n1 = tp.split(tp.cfg.n_ssm_heads)
    hd = tp.cfg.ssm_head_dim
    return n0, n1, n0 * hd, n1 * hd


def mamba2_local(p: dict, tp) -> dict:
    """The weights of this rank's heads of a mamba2 layer: z, x and dt of
    its heads, B and C whole."""
    cfg = tp.cfg
    di, n = cfg.d_inner, cfg.ssm_state
    n0, n1, c0, c1 = _mamba2_ranges(tp)
    bc = (2 * di, 2 * di + 2 * n)
    out = {"in_proj": tp.take(p, "in_proj", 1, [
        (c0, c1), (di + c0, di + c1), bc,
        (bc[1] + n0, bc[1] + n1)]),
        "conv": tp.take(p, "conv", 0, [(c0, c1), (di, di + 2 * n)])}
    for name in ("A_log", "D", "dt_bias"):
        out[name] = tp.take(p, name, 0, [(n0, n1)])
    for name in ("norm_scale", "out_proj"):
        out[name] = tp.take(p, name, 0, [(c0, c1)])
    return out


def mamba2_conv_channels(tp) -> torch.Tensor:
    """The conv channels this rank's heads read: their x, then B and C."""
    cfg = tp.cfg
    _, _, c0, c1 = _mamba2_ranges(tp)
    return torch.cat([torch.arange(c0, c1), torch.arange(
        cfg.d_inner, cfg.d_inner + 2 * cfg.ssm_state)])


def mamba2_conv_block(tp, whole: torch.Tensor, new: torch.Tensor,
                      width: int) -> torch.Tensor:
    """This rank's block (``width`` channels) of the new conv state of
    every channel, from the old state ``whole`` (B, K-1, C) and the new
    state of its own channels ``new``: the x channels of every rank's
    heads are all-gathered."""
    if tp.cfg.n_ssm_heads % tp.size:
        raise ValueError(f"mamba2 decode over a model axis of {tp.size} "
                         f"needs its {tp.cfg.n_ssm_heads} heads to divide it")
    c = new.shape[-1] - 2 * tp.cfg.ssm_state
    last = new[:, -1]
    x_all = tp.gather(last[:, :c], -1)
    state = torch.cat([whole[:, 1:], torch.cat([x_all, last[:, c:]],
                                               -1)[:, None]], 1)
    return state.narrow(-1, tp.rank * width, width)


def _mamba2_split(p: dict, u: torch.Tensor, state: int):
    """z, the conv input xbc and dt of u @ in_proj."""
    di = p["out_proj"].shape[0]
    nh = p["A_log"].shape[-1]
    return (u @ p["in_proj"]).split([di, di + 2 * state, nh], dim=-1)


def _mamba2_out(p: dict, y: torch.Tensor, z: torch.Tensor,
                dtype: torch.dtype, tp=None) -> torch.Tensor:
    """Gate, grouped RMSNorm and out-projection of y (float32, (..., di));
    under ``tp`` the norm's mean square sums over the model group."""
    y = y.to(dtype) * F.silu(z)
    if tp is None:
        var = y.float().square().mean(-1, keepdim=True)
    else:
        var = tp.sum_inside(y.float().square().sum(-1, keepdim=True)) / \
            tp.cfg.d_inner
    y = (y.float() * torch.rsqrt(var + 1e-5) *
         (1.0 + p["norm_scale"])).to(dtype)
    return y @ p["out_proj"]


def mamba2_scan(dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                xh: torch.Tensor, a: torch.Tensor, chunk: int
                ) -> torch.Tensor:
    """The SSD scan from a zero state, chunk by chunk, in the reference's
    form: dt (B, S, nh), B, C (B, S, N), xh (B, S, nh, hd), a (nh,) -> y
    (B, S, nh, hd) float32.  Within a chunk the decay matrix ``exp(gap)``,
    its product with C.B and ``dt x`` are in the compute type (xh's),
    every product over them accumulates in float32."""
    bsz, s, nh, head_dim = xh.shape
    chunk = min(chunk, s)
    assert s % chunk == 0
    cdt, dev = xh.dtype, xh.device
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=dev).tril()[None, :, :, None]
    zero = torch.zeros((), dtype=cdt, device=dev)
    h = torch.zeros((bsz, nh, head_dim, bmat.shape[-1]),
                    dtype=torch.float32, device=dev)
    ys = []
    for i in range(0, s, chunk):
        dt_i, b_i, c_i, x_i = (t[:, i:i + chunk]
                               for t in (dt, bmat, cmat, xh))
        ell = torch.cumsum(dt_i.float() * a, dim=1)      # (B, C, nh), < 0
        # M[t, tau] = exp(ell_t - ell_tau) (C_t . B_tau), tau <= t
        cb = torch.einsum("btn,bsn->bts", c_i.float(), b_i.float())
        ell_c = ell.to(cdt)
        gap = ell_c[:, :, None, :] - ell_c[:, None, :, :]  # (B, t, s, nh)
        m = torch.where(tri, torch.exp(gap), zero) * cb[..., None].to(cdt)
        dx = (dt_i[..., None] * x_i.float()).to(cdt)     # (B, C, nh, hd)
        y_intra = torch.einsum("btsh,bshp->bthp", m.float(), dx.float())
        # the carried state's contribution
        y_inter = torch.einsum("bhpn,btn,bth->bthp", h, c_i.float(),
                               torch.exp(ell))
        w = torch.exp(ell[:, -1:, :] - ell).to(cdt)      # decay to chunk end
        h = h * torch.exp(ell[:, -1])[:, :, None, None] + torch.einsum(
            "bth,bthp,btn->bhpn", w.float(), dx.float(), b_i.float())
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)


def mamba2_forward(p: dict, u: torch.Tensor, *, state: int, head_dim: int,
                   chunk: int = 128, unroll: bool = False,
                   tp=None) -> torch.Tensor:
    """u: (B, S, d) -> (B, S, d).  ``unroll`` is the reference's compile
    switch and has no effect here."""
    if tp is not None:
        p, u = mamba2_local(p, tp), tp.enter(u)
    bsz, s, _ = u.shape
    di = p["out_proj"].shape[0]
    nh = di // head_dim
    z, xbc, dt = _mamba2_split(p, u, state)
    xbc = F.silu(causal_conv1d(xbc, p["conv"]))
    x, bmat, cmat = xbc.split([di, state, state], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])                   # (B, S, nh)
    a = -torch.exp(p["A_log"].float())                   # (nh,)
    xh = x.reshape(bsz, s, nh, head_dim)
    y = mamba2_scan(dt, bmat, cmat, xh, a, chunk)         # (B, S, nh, hd)
    y = y + xh.float() * p["D"][:, None]
    return _mamba2_out(p, y.reshape(bsz, s, di), z, u.dtype, tp)


def mamba2_step(p: dict, u_t: torch.Tensor, st: Mamba2State, *, state: int,
                head_dim: int, tp=None) -> tuple[torch.Tensor, Mamba2State]:
    """Under ``tp`` the state holds the rank's heads and the conv state the
    channels of :func:`mamba2_conv_channels`."""
    if tp is not None:
        p = mamba2_local(p, tp)
    bsz = u_t.shape[0]
    di = p["out_proj"].shape[0]
    nh = di // head_dim
    z, xbc, dt = _mamba2_split(p, u_t, state)
    xbc, conv_new = conv_step(xbc, st.conv, p["conv"])
    x, bmat, cmat = F.silu(xbc).split([di, state, state], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])                   # (B, nh)
    a = -torch.exp(p["A_log"].float())
    xh = x.reshape(bsz, nh, head_dim)
    decay = torch.exp(dt.float() * a)                    # (B, nh)
    drive = (dt[..., None, None] * xh[..., None] *
             bmat[:, None, None, :]).float()
    h = decay[..., None, None] * st.ssm + drive
    y = torch.einsum("bhpn,bn->bhp", h, cmat.float())
    y = y + xh.float() * p["D"][:, None]
    return (_mamba2_out(p, y.reshape(bsz, di), z, u_t.dtype, tp),
            Mamba2State(conv_new, h))
