"""The benchmark's metrics, one reader a file: ``<name>.py`` defines
``read(run)``, which returns the metric's value from a finished run
(``qbench.harness.Run``), or None where the run holds nothing to read,
and the harness then leaves the metric out of the line."""
