"""Serving the LM substrate through the port's Executor (`launch/serve`),
training it (`launch/train`), and the step functions both call
(`launch/steps`)."""
