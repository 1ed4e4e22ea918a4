"""Host-side event data path of the port (counterpart of ``esr_tpu.data``).

Pure numpy; ``h5py`` is imported only when an HDF5 recording is opened.
"""
