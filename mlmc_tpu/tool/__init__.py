"""Host-side tools: storage schema, configuration, mesh and field I/O."""
import importlib


def require(module, purpose):
    """Import an optional dependency where it is first needed.

    ``import mlmc_tpu`` and the device path need only numpy, scipy and JAX;
    HDF5 storage (h5py) and YAML configuration (yaml) load their package on
    use.

    :raises ImportError: naming the missing package and what needs it
    """
    try:
        return importlib.import_module(module)
    except ImportError as exc:
        raise ImportError("%s needs the package %r, which is not installed"
                          % (purpose, module)) from exc
