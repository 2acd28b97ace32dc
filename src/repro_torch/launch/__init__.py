"""Launchers of the port (twin of ``src/repro/launch``): the LM mode of
``serve``, ``train``, the work-stealing MBE launcher ``mbe_run``, and
the dry run ``dryrun`` (with its operator counter ``hlo_stats``)."""
