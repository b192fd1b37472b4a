"""The registry of the port's knobs: the environment variables of
``ntt_tpu.config``, under the same names and defaults.

Each knob is read once, at import, into a constant of the module that
consumes it (as in the JAX package), so that a test may set the constant
itself; :func:`config_key` reads those constants, and the knob read live,
and is part of the runner cache key of ``api.ntt``: a knob flip never
serves a runner built under another setting. A runner keeps the plan it
was built under (``api.get_runner`` puts the peel and the twiddle fusion
its driver reads into ``aux``), so a flip after it is built changes
nothing in it. A knob changes the plan and the launches, never the output
words.

- ``NTT_MXU_BASE_LOG=5``   log2 of the peel and base transform of the
                           single-level drivers (``transforms/mxu.py``:
                           m of K1, K2, K3 single, K4). 6 runs them at
                           m = 64; above 6 the drivers that would run
                           them at m > 64 raise ValueError: the kernels
                           contract one conv matrix of at most 64 points
- ``NTT_MXU_SUBBASE_LOG=9`` log2 of the ``mxu_sub`` peel on the narrow
                           fields (m of the multi-level K3)
- ``NTT_MXU_SUB256_LOG=0`` log2 of the ``mxu_sub`` peel on the 256-bit
                           fields (0: the single-level BASE); both peels
                           follow ``mxu.effective_subbase``, capped at 512
                           by the multi-level kernel
- ``NTT_TW_MATFOLD=1``     the 256-bit decomposition twiddles folded into
                           conv-matrix stacks (K2) and one merged table
                           (``mxu.matfold_tw_tables``)
- ``NTT_TW_STACK_MAX_NT=128`` largest stack a level may fold into
- ``NTT_TW_MERGED_MAX=2^24`` largest n with the merged level-1 table
- ``NTT_TW_RESID=auto``    level 0's periodic residual (K2 with a periodic
                           T3): ``auto`` above TW_MERGED_MAX, ``1`` at
                           every size where level 0 folds, ``0`` never
- ``NTT_FUSE_TW=1``        the twiddle inside the level kernels of
                           ``mxu_chunked``; 0 (with NTT_TW_MATFOLD=0, or
                           ``api.get_runner`` raises ValueError) runs the
                           base kernel, then a plain product
- ``NTT_DEBUG=0``          the canonicity check of the transform's input
                           and output (``limbs.debug_check``; read live)

No counterpart, and the port does not read them. Three change the plan of
the JAX package's plain ladders and four-step and never its output words;
the JAX package measured each as a loss and leaves it off by default, and
the port keeps the default plan: ``NTT_RADIX4`` (the ladders' stages in
pairs, ``ntt_tpu.transforms.core.dit_stage4``), ``NTT_RESIDENT_SPLIT``
(the four-step peels the largest length whose planes fit the TPU's VMEM,
``ntt_tpu.transforms.fourstep._split`` given a field) and
``NTT_FACTOR_TW_MIN`` (the top level's table factored into two small
ones, ``ntt_tpu.api._factor_split``). The rest: ``NTT_MXU_BT``,
``NTT_DIMSEM``, ``NTT_VMEM_LIMIT_MB``, ``NTT_LOOP_MIN_HALVES``,
``NTT_LOOP_SINGLE`` and ``NTT_FORCE_MOSAIC`` shape only the TPU build (its
batch tiles, grid semantics, VMEM cap, loop form of the limb arithmetic and
lowering path); ``NTT_MXU_FOLD`` picks the TPU kernels' reduction, and the
port's kernels reduce with 32-bit Montgomery steps by design.
"""

from __future__ import annotations

import os

from .transforms import mxu


def config_key() -> tuple:
    """Every knob, as the module that consumes it holds it (the constants,
    so a test that sets one is seen), and the knob read live."""
    return (mxu.BASE_LOG, mxu.BASE, mxu.SUBBASE_LOG, mxu.SUBBASE,
            mxu.SUB256_LOG, mxu.TW_MATFOLD, mxu.TW_STACK_MAX_NT,
            mxu.TW_MERGED_MAX, mxu.TW_RESID, mxu.FUSE_TW,
            os.environ.get("NTT_DEBUG", "0"))
