"""The port's checking and timing tools, each the counterpart of the
repository's ``tools/<name>.py`` and run as
``python3 -m ntt_tpu_torch.tools.<name> [arguments] [--device DEV]``:

- ``healthcheck``: every algorithm name at a small size against the golden
  NTT; ``--deep`` the production ladder up to BLS12-381 Fr 2^22;
- ``sweep``: one JSON line a size (time, butterflies a second, bit-exact);
- ``shootout``: every algorithm name timed at one size;
- ``microbench``: the transform's building blocks timed alone, and
  ``knockout``, the fused level cut after each stage (kernel K7) and the
  twiddle-stack level (kernel K2);
- ``scaling``: the multi-device four-step on 1, 2, 4 and 8 shards of one
  card at fixed work a shard.

Each takes the reference tool's positional arguments and environment
variables under the same names and defaults, runs on the CUDA card unless
``--device`` names another device (``--device cpu`` runs the kernels'
plain versions) and exits non-zero without a card. Importing them loads
neither JAX nor ``ntt_tpu``.
"""
