"""Training-curve plotting — the port of ``paddle_tpu/plot.py``
(python/paddle/v2/plot/plot.py parity).

Ploter collects (step, value) series per title and renders them with
matplotlib when available; `DISABLE_PLOT=True` (the reference's escape
hatch for headless test runs) or a missing matplotlib degrades to a
silent data collector, so scripts written against the reference run
unchanged."""

from __future__ import annotations

import os
from typing import Dict, List


class PlotData:
    def __init__(self):
        self.step: List[float] = []
        self.value: List[float] = []

    def append(self, step, value):
        self.step.append(step)
        self.value.append(float(value))

    def reset(self):
        self.step = []
        self.value = []


class Ploter:
    def __init__(self, *args: str):
        self.__args__ = args
        self.__plot_data__: Dict[str, PlotData] = {t: PlotData()
                                                   for t in args}
        self.__disable_plot__ = os.environ.get("DISABLE_PLOT") == "True"
        self._plt = None
        if not self.__disable_plot__:
            try:
                import matplotlib
                matplotlib.use("Agg")
                import matplotlib.pyplot as plt
                self._plt = plt
            # any import failure (no matplotlib, no backend) degrades
            # to the data collector, as in the reference
            except Exception:  # noqa: BLE001
                self.__disable_plot__ = True

    def append(self, title: str, step, value):
        assert title in self.__plot_data__, f"unknown series {title!r}"
        self.__plot_data__[title].append(step, value)

    def data(self, title: str) -> PlotData:
        return self.__plot_data__[title]

    def plot(self, path: str = None):
        if self.__disable_plot__ or self._plt is None:
            return
        titles = []
        for title in self.__args__:
            d = self.__plot_data__[title]
            if d.step:
                titles.append(title)
                self._plt.plot(d.step, d.value)
        self._plt.legend(titles, loc="upper left")
        if path:
            self._plt.savefig(path)
        self._plt.gcf().clear()

    def reset(self):
        for d in self.__plot_data__.values():
            d.reset()
