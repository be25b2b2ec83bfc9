"""The benchmark of navier_stokes_tpu_torch on one NVIDIA H100: DFG cylinder
flows, the time of an implicit time step (``run.py``)."""
