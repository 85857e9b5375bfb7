"""The numpy golden reference of the CLI's ``--cpu-golden``."""

from . import golden

__all__ = ["golden"]
