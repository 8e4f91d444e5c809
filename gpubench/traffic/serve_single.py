"""One interactive client in a closed loop: one request a ``Server.serve``
call, the next sent when the last returns, no think time.  The serving
driver of ``serve_backlog`` with ``requests_per_call`` 1, which also takes
each request's latency: the harness's clock from ``serve([request])`` to its
return."""

from gpubench.traffic.serve_backlog import Driver

__all__ = ["Driver"]
