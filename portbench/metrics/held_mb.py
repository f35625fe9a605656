"""held_mb: MB (1e6 bytes) of host chunks that the program's task graph
holds when the window closes (``CTGraph.held_bytes``): the inputs, the
products the harness keeps to check, and whatever a product leaves
behind."""


def read(run):
    prog = getattr(run, "program", None)
    held = prog and prog.get("held_bytes")
    return held / 1e6 if held else None
