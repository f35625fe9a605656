"""Plan replay, the SCF idiom (new values, same structure): set-up
compiles ``plan = sess.compile(<operator call>)`` in a lazy Session, and
each product runs ``plan.run(<first operand>=M_k, flush=False)`` (the
``rebind`` span) before the harness flushes.  M_k takes the mix's
``value_sets`` value sets of the pattern in turn, built in set-up after
the operands (value sets ``len(OPERANDS)`` on), starting at
``seed % value_sets``.  The plan writes every run into one result, so
only the window's last product can be checked."""

LAZY = True
REUSES_OUTPUT = True


def start(ctx):
    return Replay(ctx)


class Replay:
    def __init__(self, ctx):
        self.ctx = ctx
        ops = ctx.op.OPERANDS
        self.sets = {s: k for k, s in enumerate(ops)}
        mats = {s: ctx.build(k, name=s) for s, k in self.sets.items()}
        self.first = ops[0]
        self.alts = [(k, ctx.build(k)) for k in
                     range(len(ops), len(ops) + int(ctx.mix["value_sets"]))]
        self.start = ctx.seed % len(self.alts)
        self.plan = ctx.sess.compile(ctx.op.call(mats))

    def warm(self):
        self.plan.run(flush=False)
        self.ctx.sess.flush()

    def issue(self, n):
        k, m = self.alts[(n + self.start) % len(self.alts)]
        with self.ctx.rec.span("rebind"):
            out = self.plan.run(flush=False, **{self.first: m})
        return out, dict(self.sets, **{self.first: k})

    def release(self, out):
        pass
