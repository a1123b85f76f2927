"""Selection over stored objects for the volume server's ``/query``."""

from .json_query import execute_query, match_filter, project

__all__ = ["execute_query", "project", "match_filter"]
