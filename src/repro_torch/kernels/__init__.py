"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain
PyTorch versions.  Importing this package builds nothing: a kernel is built
on its first launch on a CUDA tensor (`build.library`).

The reference's TPU block autotuner, `repro/kernels/blocking.py`
(``pick_blocks``: Pallas block shapes per chip and shape, within the
VMEM budget, padded to the (8, 128) tile), has no twin here, because each
kernel's launch geometry is fixed and takes every width as it is:

* `embed_gather`'s word path, `pm_combine` and `scatter_rows`: blocks of
  8 warps, one row per warp, each warp over a chunk of 128 words of the
  widest word (16, 8, 4 or 2 bytes) that divides the row and both base
  pointers, 4 words in flight per lane;
* `embed_gather`'s TMA path (rows of a multiple of 16 bytes on 16-byte
  aligned bases, up to 32 MiB written): persistent one-warp blocks,
  three per SM, each a ring of shared-memory stages filled and drained
  by ``cp.async.bulk``; the choice reads only size and alignment
  (`embed_gather.embed_gather_path`);
* `adagrad_rows`: blocks of 8 warps over (row, column chunk), float4
  words where the width allows, scalars otherwise;
* `segment_scatter_rows`: one-warp blocks over (sorted position, column
  chunk), 16-byte stores where the width and alignment allow;
* `selective_scan` (Mamba-1; N = 16 states only): 4-warp blocks over
  (32 channels, sequence), 4 lanes a channel and 4 states a lane, time
  walked in order in tiles of 16 positions; a ragged last block of
  channels and tile of positions compute on zeros.

No width is padded: a row splits into words and a ragged last chunk
(``chip_smoke.py`` holds every row kernel bit for bit at D in {1, 8,
576, 6144} and on unaligned copies).  And no per-shape measurement is needed:
at the main paths' shapes the gather, the combine and the row update
reach 70 to 100 % of their memory bounds, and the two scatters are
launch-bound (bounds under a microsecond) and within 10 % of their
library calls (PERF.md §6), so a block shape could move none of them."""
