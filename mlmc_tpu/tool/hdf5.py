"""HDF5 schema layer — checkpoint/resume-compatible with the reference.

Re-design of reference mlmc/tool/hdf5.py:6-451. The on-disk schema is kept
verbatim (root attrs ``version``/``level_parameters``; per-level group
``/Levels/<l>`` with datasets ``scheduled`` (S100), ``collected_values``
(N x 2 x M float64, resizable), ``collected_ids``, ``failed`` (S100, S1000),
attr ``n_ops_estimate=[time, n_samples]``) so existing reference files
resume under this framework and vice versa.

Difference from the reference: one persistent (lazily opened) h5py handle
per file instead of open-per-call — the device read path streams whole
level chunks and open/close per chunk would dominate. ``close()`` /
context-manager support flushes for checkpoint handoff.
"""
import numpy as np

from mlmc_tpu.quantity.quantity_spec import ChunkSpec
from mlmc_tpu.tool import require


class HDF5:
    """File-level schema management (root attrs + Levels group)."""

    VERSION = "1.0.1"

    def __init__(self, file_path, load_from_file=False):
        self.file_name = file_path
        self._load_from_file = load_from_file
        self._file = None
        if load_from_file:
            self.load_from_file()

    # ------------------------------------------------------------------ #
    @property
    def file(self):
        """The open ``h5py.File`` (opened on first use)."""
        if self._file is None:
            h5py = require("h5py", "HDF5 sample storage")
            self._file = h5py.File(self.file_name, "a")
        return self._file

    def close(self):
        """Close the underlying h5py file handle."""
        if self._file is not None:
            self._file.close()
            self._file = None

    def flush(self):
        """Flush pending writes to disk."""
        if self._file is not None:
            self._file.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------ #
    def create_file_structure(self, level_parameters):
        """Create (or reload, on resume) the header + /Levels groups."""
        if self._load_from_file:
            self.load_from_file()
        else:
            self.clear_groups()
            self.init_header(level_parameters=level_parameters)

    def load_from_file(self):
        """Load root attrs (version, level_parameters) into attributes."""
        for attr_name, value in self.file.attrs.items():
            self.__dict__[attr_name] = value
        if "level_parameters" not in self.__dict__:
            raise Exception(
                "'level_parameters' aren't stored in HDF file, unable to create level groups")

    def clear_groups(self):
        """Drop every /Levels group (fresh-start runs)."""
        for item in list(self.file.keys()):
            del self.file[item]

    def init_header(self, level_parameters):
        """Write the root attrs (version, level_parameters)."""
        self.file.attrs["version"] = self.VERSION
        self.file.attrs["level_parameters"] = np.asarray(level_parameters, dtype=float)
        self.file.create_group("Levels")

    def add_level_group(self, level_id: str):
        """Create /Levels/<id> if absent; return its LevelGroup."""
        path = "/Levels/" + level_id
        if path not in self.file:
            self.file["Levels"].create_group(level_id)
        return LevelGroup(self, path, level_id)

    @property
    def result_format_dset_name(self):
        return "result_format"

    def save_result_format(self, result_format, res_dtype):
        """Result format as a structured dataset (reference hdf5.py:122-150)."""
        data = np.empty(len(result_format), dtype=res_dtype)
        for i, spec in enumerate(result_format):
            data[i]["name"] = spec.name.encode()
            data[i]["unit"] = spec.unit.encode()
            data[i]["shape"] = np.asarray(spec.shape, dtype=np.int32)
            data[i]["times"] = np.asarray(spec.times, dtype=float)
            data[i]["locations"] = [
                loc.encode() if isinstance(loc, str) else np.asarray(loc, dtype=float)
                for loc in spec.locations
            ]
        if "result_format" in self.file:
            del self.file["result_format"]
        self.file.create_dataset("result_format", data=data)

    def load_result_format(self):
        """Read the stored QuantitySpec list back from the file."""
        if "result_format" not in self.file:
            raise AttributeError("result_format dataset not in HDF file")
        return self.file["result_format"][()]

    def load_level_parameters(self):
        """Read the per-level simulation steps from the root attrs."""
        return self.file.attrs.get("level_parameters", [])


class LevelGroup:
    """Per-level datasets: scheduled / collected / failed / cost attr."""

    SCHEDULED_DTYPE = {"names": ["sample_id"], "formats": ["S100"]}
    FAILED_DTYPE = {"names": ("sample_id", "message"), "formats": ("S100", "S1000")}

    # dataset-name properties (reference hdf5.py:270-295 API)
    @property
    def scheduled_dset(self):
        return "scheduled"

    @property
    def collected_ids_dset(self):
        return "collected_ids"

    @property
    def failed_dset(self):
        return "failed"

    def __init__(self, hdf: HDF5, hdf_group_path, level_id, loaded_from_file=False):
        self._hdf = hdf
        self.level_id = level_id
        self.level_group_path = hdf_group_path

        group = self.group
        if "level_id" not in group.attrs:
            group.attrs["level_id"] = self.level_id
        if not loaded_from_file:
            self._make_datasets()

    @property
    def group(self):
        return self._hdf.file[self.level_group_path]

    def _make_datasets(self):
        self._make_dataset("scheduled", shape=(0,), maxshape=(None,),
                           dtype=LevelGroup.SCHEDULED_DTYPE)
        self._make_dataset("collected_ids", shape=(0,), maxshape=(None,),
                           dtype=LevelGroup.SCHEDULED_DTYPE)
        self._make_dataset("failed", shape=(0,), maxshape=(None,),
                           dtype=LevelGroup.FAILED_DTYPE)

    def _make_dataset(self, name, shape, maxshape, dtype, chunks=True):
        if name not in self.group:
            self.group.create_dataset(name, shape=shape, dtype=dtype,
                                      maxshape=maxshape, chunks=chunks)
        return name

    def _append_dataset(self, dataset_name, values):
        if len(values) == 0:
            # dataset[-0:] selects EVERY row — an empty append must no-op,
            # not overwrite (or shape-error on) the existing data
            return
        dataset = self.group[dataset_name]
        dataset.resize(dataset.shape[0] + len(values), axis=0)
        dataset[-len(values):] = values

    # ------------------------------------------------------------------ #
    def append_scheduled(self, scheduled_samples):
        """Append sample-id strings to the resizable scheduled dataset."""
        if len(scheduled_samples) > 0:
            self._append_dataset(
                "scheduled", [(s.encode(),) for s in scheduled_samples])

    def append_successful(self, ids, values):
        """:param ids: list of sample id strings
        :param values: np.ndarray [N, 2, M] (fine, coarse) flattened results
        """
        self._append_dataset("collected_ids", [(s.encode(),) for s in ids])
        values = np.asarray(values, dtype=np.float64)
        if "collected_values" not in self.group:
            self.group.create_dataset(
                "collected_values",
                shape=(0,) + values.shape[1:],
                dtype=np.float64,
                maxshape=(None,) + values.shape[1:],
                chunks=True,
            )
        self._append_dataset("collected_values", values)

    def append_failed(self, failed_samples):
        """:param failed_samples: list of (sample_id, error message)"""
        self._append_dataset(
            "failed",
            [(sid.encode(), msg.encode()[:1000]) for sid, msg in failed_samples])

    # ------------------------------------------------------------------ #
    def scheduled(self):
        """The raw scheduled dataset ([N, 1] S100 ids)."""
        return self.group["scheduled"][()]

    def chunks(self, n_samples=None):
        """Yield ChunkSpecs over the collected sample axis (one per HDF5
        storage chunk; a scheduled-but-empty level yields one empty
        chunk so iteration stays uniform)."""
        if "collected_values" not in self.group:
            # a scheduled-but-empty level: one empty chunk, so level
            # iteration stays uniform across backends
            yield ChunkSpec(chunk_id=0, chunk_slice=slice(0, 0, 1),
                            level_id=int(self.level_id))
            return
        dataset = self.group["collected_values"]
        if n_samples is not None:
            yield ChunkSpec(chunk_id=0, chunk_slice=slice(0, n_samples, 1),
                            level_id=int(self.level_id))
        else:
            # slice the SAMPLE axis only (dataset is [N, 2, M]; h5py
            # iter_chunks would duplicate N-slices per 2/M-axis block)
            n = dataset.shape[0]
            step = dataset.chunks[0] if dataset.chunks else max(n, 1)
            for chunk_id, start in enumerate(range(0, max(n, 1), step)):
                yield ChunkSpec(chunk_id=chunk_id,
                                chunk_slice=slice(start, min(start + step, n), 1),
                                level_id=int(self.level_id))

    def collected(self, chunk_slice):
        """Read ``collected_values[chunk_slice]`` ([n, 2, M] or None)."""
        if "collected_values" not in self.group:
            return None
        return self.group["collected_values"][chunk_slice]

    def collected_n_items(self):
        """Number of collected samples on this level."""
        if "collected_values" not in self.group:
            return 0
        return self.group["collected_values"].shape[0]

    def get_finished_ids(self):
        """Successful + failed sample ids (everything no longer running)."""
        failed_ids = [s[0].decode() for s in self.group["failed"][()]]
        successful_ids = [s[0].decode() for s in self.group["collected_ids"][()]]
        return np.concatenate((np.array(successful_ids, dtype=object),
                               np.array(failed_ids, dtype=object)), axis=0)

    def get_unfinished_ids(self):
        """scheduled - finished: the resume set (reference hdf5.py:400-406)."""
        scheduled_ids = [s[0].decode() for s in self.scheduled()]
        return list(set(scheduled_ids) - set(self.get_finished_ids()))

    def get_failed_ids(self):
        """Sample ids stored in the failed dataset."""
        return [s[0].decode() for s in self.group["failed"][()]]

    def clear_failed_dataset(self):
        """Drop + recreate the failed dataset (renew-failed support)."""
        if "failed" in self.group:
            del self._hdf.file[self.level_group_path + "/failed"]
            self._make_dataset("failed", shape=(0,), maxshape=(None,),
                               dtype=LevelGroup.FAILED_DTYPE)

    # ------------------------------------------------------------------ #
    @property
    def n_ops_estimate(self):
        if "n_ops_estimate" in self.group.attrs:
            return self.group.attrs["n_ops_estimate"]
        return None

    @n_ops_estimate.setter
    def n_ops_estimate(self, n_ops_estimate):
        self.group.attrs["n_ops_estimate"] = np.asarray(n_ops_estimate, dtype=float)
