# Ported from distributed_matvec_tpu/io/__init__.py.
"""HDF5 golden/checkpoint I/O (the MyHDF5.chpl layer); ``h5py`` is
imported when a file is read or written."""

from .hdf5 import (  # noqa: F401
    load_basis,
    load_eigen,
    make_or_restore_representatives,
    save_basis,
    save_eigen,
)
