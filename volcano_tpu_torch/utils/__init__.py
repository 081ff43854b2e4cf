"""Scheduler utilities."""

from .priority_queue import PriorityQueue

__all__ = ["PriorityQueue"]
