"""Transforms of the port: host tables, the four-step recursion and the
digit-matmul (``mxu_chunked``) transform."""
