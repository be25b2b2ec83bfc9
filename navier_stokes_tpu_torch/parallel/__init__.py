"""Multi-rank runs: ports of ``navier_stokes_tpu/parallel``.

  bootstrap       joining the process group (torchrun's environment), rank
                  queries, the device of a rank
  spmd            the flat operator's design: Morton chunks of the cells a
                  rank, vectors replicated, every assembly and product
                  all-reduced (the rank's slice of the flat context)
  windowed_spmd   the owned-range domain decomposition of the windowed
                  operator: each rank owns a contiguous run of layout
                  blocks; host-side layouts, shards and row maps

The exchange of edge blocks itself lives beside the kernels it feeds
(``ops/windowed.py``: ``_halo_edges``, ``_combine_edges``), and the
all-reduces in ``la/operators.py`` (the windowed operator's dots, the flat
operator's products) and ``fem/assembly.py`` (the flat residual).
"""
