"""Transforms of the port: host tables, the four-step recursion and the
digit-matmul transforms (``mxu_chunked``, ``mxu_sub``)."""
