"""The benchmark's own spans around calls into the program's layers:
`torch.profiler.record_function` labels, on for the profiled stretch
only, so that the trace names what the host was doing while the device
waited. The program's code is not changed: an attribute of one of its
objects or modules is wrapped and put back."""
from __future__ import annotations

from typing import List, Sequence, Tuple


class Spans:
    def __init__(self, targets: Sequence[Tuple[object, str, str]]):
        """``targets``: (object or module, attribute, label) triples."""
        self.targets = list(targets)
        self._saved: List[Tuple[object, str, object, bool]] = []

    @property
    def labels(self) -> Tuple[str, ...]:
        return tuple(label for _, _, label in self.targets)

    def on(self) -> None:
        from torch.profiler import record_function

        for obj, attr, label in self.targets:
            real = getattr(obj, attr)
            own = attr in getattr(obj, "__dict__", {})

            def wrapped(*args, _real=real, _label=label, **kwargs):
                with record_function(_label):
                    return _real(*args, **kwargs)

            self._saved.append((obj, attr, real, own))
            setattr(obj, attr, wrapped)

    def off(self) -> None:
        while self._saved:
            obj, attr, real, own = self._saved.pop()
            if own:
                setattr(obj, attr, real)
            else:
                delattr(obj, attr)
