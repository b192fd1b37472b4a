"""Transforms of the port: host tables and the butterfly ladders (``core``,
``naive``), the four-step recursion and its ladder transforms (``fourstep``),
and the digit-matmul transforms (``mxu``)."""
