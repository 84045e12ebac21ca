"""The comparisons that decide ``correct``, one module each, named by a
traffic mix's ``check`` key (``density`` where it has none). Each module
has ``judge(run, jobs)`` (see ``check.py``)."""
