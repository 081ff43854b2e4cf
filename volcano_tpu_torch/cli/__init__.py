"""vcctl, the operator CLI, and its standalone verbs."""

from .vcctl import JobCommands, QueueCommands, main

__all__ = ["JobCommands", "QueueCommands", "main"]
