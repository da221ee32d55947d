"""Live appending datasets: incremental discovery of the files a producer
appends while a job reads (the JAX package's ``petastorm_tpu/discovery``,
whose ``docs/live_data.md`` describes it).

* :mod:`~petastorm_tpu_torch.discovery.listing`: the one raw-listing path,
  retried, deadline-bounded, fault-injectable and counted
  (``tools/check_listing.py`` checks that nothing else lists);
* :mod:`~petastorm_tpu_torch.discovery.snapshot`: immutable
  :class:`DatasetSnapshot` views in admission order, whose row-group
  ordinals only ever extend;
* :mod:`~petastorm_tpu_torch.discovery.admission`: each new file's check:
  a torn footer waits ``pending_retry``, a schema drift is admitted with a
  warning when it only adds columns and refused otherwise;
* :mod:`~petastorm_tpu_torch.discovery.watcher`: the :class:`DatasetWatcher`
  that polls, admits and stages growth for the reader to fold into its
  plan (``make_reader(refresh_interval_s=...)``).

The package imports no torch: the reader's workers may load it.
"""
from petastorm_tpu_torch.discovery.admission import (AdmittedFile, FileAdmission,
                                                     classify_schema_drift,
                                                     read_new_file_footer)
from petastorm_tpu_torch.discovery.listing import is_data_file, list_data_files
from petastorm_tpu_torch.discovery.snapshot import DatasetSnapshot, FileEntry
from petastorm_tpu_torch.discovery.watcher import DatasetWatcher

__all__ = [
    "AdmittedFile", "DatasetSnapshot", "DatasetWatcher", "FileAdmission",
    "FileEntry", "classify_schema_drift", "is_data_file", "list_data_files",
    "read_new_file_footer",
]
