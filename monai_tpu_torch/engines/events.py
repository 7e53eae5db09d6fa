"""Engine events (counterpart of monai_tpu/engines/events.py): ignite's event names, the
finer ``IterationEvents``, and a small emitter in their place."""
from __future__ import annotations

from collections import defaultdict
from collections.abc import Callable

from ..utils.enums import StrEnum

__all__ = ["EventEmitter", "Events", "IterationEvents"]


class Events(StrEnum):
    STARTED = "started"
    EPOCH_STARTED = "epoch_started"
    GET_BATCH_STARTED = "get_batch_started"
    GET_BATCH_COMPLETED = "get_batch_completed"
    ITERATION_STARTED = "iteration_started"
    ITERATION_COMPLETED = "iteration_completed"
    EPOCH_COMPLETED = "epoch_completed"
    COMPLETED = "completed"
    EXCEPTION_RAISED = "exception_raised"
    INTERRUPT = "interrupt"
    TERMINATE = "terminate"


class IterationEvents(StrEnum):
    """Events inside one iteration."""

    FORWARD_COMPLETED = "forward_completed"
    LOSS_COMPLETED = "loss_completed"
    BACKWARD_COMPLETED = "backward_completed"
    MODEL_COMPLETED = "model_completed"
    INNER_ITERATION_STARTED = "inner_iteration_started"
    INNER_ITERATION_COMPLETED = "inner_iteration_completed"


class EventEmitter:
    """ignite-style registration and firing: ``handler(engine, *args, **kwargs)``; with
    ``every=n`` only every n-th epoch or iteration, with ``event_filter`` where it says so."""

    def __init__(self):
        self._event_handlers: dict[str, list[tuple[Callable, tuple, dict]]] = defaultdict(list)

    def add_event_handler(self, event_name: str, handler: Callable, *args, **kwargs):
        every = kwargs.pop("every", None)
        event_filter = kwargs.pop("event_filter", None)
        call = handler
        if every is not None and every > 1:
            def call(engine, *a, **k):
                counter = engine.state.epoch if "epoch" in str(event_name) else engine.state.iteration
                if counter % every == 0:
                    return handler(engine, *a, **k)
        elif event_filter is not None:
            def call(engine, *a, **k):
                if event_filter(engine):
                    return handler(engine, *a, **k)
        self._event_handlers[str(event_name)].append((call, args, kwargs))
        return handler

    def has_event_handler(self, handler: Callable, event_name: str | None = None) -> bool:
        events = [str(event_name)] if event_name else list(self._event_handlers)
        return any(h is handler for e in events for (h, _, _) in self._event_handlers.get(e, []))

    def remove_event_handler(self, handler: Callable, event_name: str):
        kept = [e for e in self._event_handlers[str(event_name)] if e[0] is not handler]
        self._event_handlers[str(event_name)] = kept

    def on(self, event_name: str, *args, **kwargs):
        def decorator(f):
            self.add_event_handler(event_name, f, *args, **kwargs)
            return f

        return decorator

    def fire_event(self, event_name: str) -> None:
        for handler, args, kwargs in list(self._event_handlers.get(str(event_name), [])):
            handler(self, *args, **kwargs)
