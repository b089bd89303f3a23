"""ZMQ object-list interface — the planner-side receiver of the
reference's perception link (the object-list dummy publishes PUB
``tcp://*:47209`` topic ``v2x_to_all``; the vehicle deployment feeds the
planner the same way, ObjectListInterface.py:17).  The port's own copy of
the JAX package's ``utils/zmq_interface.py``; host code.

The receiver is non-blocking: ``poll()`` drains the socket and returns the
most recent object list (or None when nothing arrived — the caller's
staleness watchdog then fires, ObjectListInterface.py:144-151).
"""

from __future__ import annotations

from typing import Optional


class ObjectListReceiver:
    def __init__(self, endpoint: str = "tcp://localhost:47209",
                 topic: str = "v2x_to_all"):
        import zmq
        self._zmq = zmq
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.SUB)
        self._sock.setsockopt_string(zmq.SUBSCRIBE, topic)
        self._sock.connect(endpoint)
        self._topic = topic

    def poll(self, timeout_ms: int = 0) -> Optional[list]:
        """Return the newest object list received, or None."""
        zmq = self._zmq
        latest = None
        if timeout_ms and not self._sock.poll(timeout_ms):
            return None
        while True:
            try:
                topic = self._sock.recv_string(zmq.NOBLOCK)
                payload = self._sock.recv_json(zmq.NOBLOCK)
                if topic == self._topic:
                    latest = payload
            except zmq.Again:
                break
        return latest

    def close(self):
        self._sock.close(0)
