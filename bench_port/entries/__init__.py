"""The paths that a cell's jobs take into the program, one module each,
named by a traffic mix's ``entry`` key. Each module has ``prepare``,
``job``, ``finish``, ``traced_job``, ``release``, ``outputs``,
``judged``, ``agreement``, ``thresholds`` and ``pops_sum`` (see
``entries/cli.py``)."""
