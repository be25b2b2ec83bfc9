"""Checkpoints and XDMF/HDF5 output: ports of ``navier_stokes_tpu/io``.

Both write HDF5 through h5py, imported when a file is opened (as the
originals do), never when this package is imported.  ``h5py()`` is that
import with an error that says what needs it: a machine without h5py can
still run every solve, but not write or read these files.
"""

__all__ = ["h5py"]


def h5py():
    """The h5py module, or an ImportError that names it."""
    try:
        import h5py as mod
    except ImportError as e:
        raise ImportError(
            "checkpoints and XDMF/HDF5 output need h5py, which this Python "
            "cannot import; install h5py or run without --output-dir / "
            "save_checkpoint / restore_checkpoint"
        ) from e
    return mod
