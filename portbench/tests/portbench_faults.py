"""Faults planted under the timed path (``main.run(..., plant=...)``):
each one breaks what the program produces, and the run's check has to
read ``correct`` false.  Each function patches the program in the process
that calls it (every rank calls it before its set-up).  The first is the
check's control: the step in precision that would tempt a change."""
import torch


def _patch_kernels(fn):
    from repro_torch.kernels import ops
    for name in ("bsmm_pairs", "batched_gemm"):
        orig = getattr(ops, name)
        setattr(ops, name, fn(name, orig))


def tf32_operands():
    """The control: every kernel's operands rounded to TF32 (the tensor
    cores' one-pass inputs) and their products summed in float32, in
    place of the float32 products the configurations state.  The kernels
    run on the rounded operands, whose products they form exactly."""
    from pbench.reference import tf32_round

    def wrap(name, orig):
        if name == "bsmm_pairs":
            return lambda a, b, *r, **kw: orig(tf32_round(a), tf32_round(b),
                                               *r, **kw)
        return lambda a, b: orig(tf32_round(a), tf32_round(b))
    _patch_kernels(wrap)


def altered_answer():
    """One element of every kernel result altered where it is produced."""
    def wrap(name, orig):
        def f(*a, **kw):
            c = orig(*a, **kw)
            c.view(-1)[0] += 1.0
            return c
        return f
    _patch_kernels(wrap)


def state_unchanged():
    """The kernel returns without computing: C's blocks keep the zeros
    they were allocated with."""
    def wrap(name, orig):
        return lambda *a, **kw: torch.zeros_like(orig(*a, **kw))
    _patch_kernels(wrap)


def half_the_batch():
    """Half of every wave's block pairs left out (the odd ones)."""
    def wrap(name, orig):
        if name == "bsmm_pairs":
            def f(a, b, sa, sb, seg, *, cap_c):
                seg = seg.clone()
                seg[1::2] = cap_c           # an invalid slot: skipped
                return orig(a, b, sa, sb, seg, cap_c=cap_c)
            return f

        def g(a, b):
            out = orig(a, b)
            out[1::2] = 0
            return out
        return g
    _patch_kernels(wrap)


def no_exchange():
    """The ring shifts between ranks left out: every received block is
    zeros."""
    from repro_torch.core import distributed as cdist
    from repro_torch.launch import mesh_exec
    cdist.ring_shift = lambda group, sends: [torch.zeros_like(x)
                                             for x, _ in sends]
    mesh_exec.cdist = cdist


def _patch_tau(change):
    """Every truncated multiply of the program run at ``change(tau)``."""
    from repro_torch.api.matrix import Matrix
    orig = Matrix.multiply

    def multiply(self, other, tau=None):
        tau = self.session.tau if tau is None else tau
        return orig(self, other, tau=change(float(tau)))
    Matrix.multiply = multiply


def tau_zero():
    """A truncated multiply that truncates nothing."""
    _patch_tau(lambda tau: 0.0)


def tau_times_ten():
    """A truncated multiply that drops ten times too much."""
    _patch_tau(lambda tau: 10.0 * tau)
