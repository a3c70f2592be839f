"""The framework-free DSL layer and the plan/executor stack of the port.

Nothing is imported eagerly: ``dsl``/``algorithms``/``passes``/``verify``
are pure Python, and ``executor``/``comm`` need torch.
"""
