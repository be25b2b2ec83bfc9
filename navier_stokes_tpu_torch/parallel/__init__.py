"""Multi-rank runs: ports of ``navier_stokes_tpu/parallel``.

  bootstrap       joining the process group (torchrun's environment), rank
                  queries, the device of a rank
  windowed_spmd   the owned-range domain decomposition of the windowed
                  operator: each rank owns a contiguous run of layout
                  blocks; host-side layouts, shards and row maps

The exchange of edge blocks itself lives beside the kernels it feeds
(``ops/windowed.py``: ``_halo_edges``, ``_combine_edges``), and the
all-reduced dots in ``la/operators.py``.  The flat replicated design of the
original's ``parallel/spmd.py`` is not ported.
"""
