"""The paths that a cell's jobs take into the program, one module each,
named by a traffic mix's ``entry`` key. Each module has ``prepare``,
``job``, ``finish``, ``traced_job``, ``release``, ``judged`` and
``agreement``, and ``thresholds`` for the ``density`` comparison (see
``entries/cli.py``); the comparisons read a job's outputs from its record
(``check.py``)."""
