"""Serving the LM substrate through the port's Executor (`launch/serve`)
and the step functions it calls (`launch/steps`)."""
