"""from_coo_s: seconds of the program's ``qt.from_coo`` span (the
quadtree's construction from coordinates inside ``Session.from_pattern``)
in set-up: the mean over the cell's inputs, rank 0's."""


def read(run):
    prog = getattr(run, "program", None)
    if not prog or not prog.get("spans"):
        return None
    t = [b - a for n, a, b, *_ in prog["spans"]
         if n == "qt.from_coo" and a < prog["window"][0]]
    return sum(t) / len(t) if t else None
