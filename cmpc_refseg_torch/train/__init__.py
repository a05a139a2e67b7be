"""The port's train step: optimizer and trainer."""
