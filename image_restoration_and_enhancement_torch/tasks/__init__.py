"""The four-task registry."""
