"""Chunks and Tasks core of the port: chunks, the task graph, quadtree
matrices, the multiply task programs and the leaf engines."""
