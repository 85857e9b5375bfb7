"""The benchmark's CPU tests: `python -m pytest benchmark/tests` from the
checkout's root. Tests that need the card are marked ``gpu`` and skip
without one."""
