"""Serving: the batch-1 predict service and its HTTP front end."""
