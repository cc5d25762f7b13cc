"""Closure training through the solver: losses, Adam, the train steps."""
