"""A fresh operator call per product, as a user calls the multiply: the
call registers the product (the ``register`` span), the harness flushes
it, and once used it is freed with ``Session.free``.  The operands are
value sets 0, 1, ... of the pattern, one per operand.  Mix parameters:
none."""

#: the Session this driver needs: eager
LAZY = False
#: every product has a result of its own
REUSES_OUTPUT = False


def start(ctx):
    return Eager(ctx)


class Eager:
    def __init__(self, ctx):
        self.ctx = ctx
        self.sets = {s: k for k, s in enumerate(ctx.op.OPERANDS)}
        self.mats = {s: ctx.build(k, name=s) for s, k in self.sets.items()}

    def warm(self):
        out = self.ctx.op.call(self.mats)
        self.ctx.sess.flush()
        self.ctx.sess.free(out)

    def issue(self, n):
        with self.ctx.rec.span("register"):
            out = self.ctx.op.call(self.mats)
        return out, self.sets

    def release(self, out):
        self.ctx.sess.free(out)
