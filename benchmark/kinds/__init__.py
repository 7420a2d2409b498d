"""Traffic kinds, one module a kind, found by the ``kind`` of a traffic
file (:func:`benchmark.drivers.kind`).  A kind's module defines
``Driver(scenario, traffic, seed, device)`` with

* ``B``, ``T``: lanes and steps of a call (1 and 1 for one car's cycle);
  ``failed``: the requests the window gave up;
* ``warm_up()``: the first calls, which capture the graphs (set-up);
* ``window(seconds) -> benchmark.drivers.Window``: the measured calls;
* ``traced_calls(n) -> callable``: ``n`` more calls for the profiler;
* ``shapes() -> dict``: the shapes the roofline readers count with;
* ``numbers(world, cfg, seed, low) -> dict``: the window's last call held
  to the plain reference (:mod:`benchmark.checks`; ``low``: the control in
  the program's place);
* optionally ``k7_in_range()``: ``(in-range cells, scans)`` of the traced
  LiDAR scans;
* for a cell on several cards, ``gather()``: called on every rank after
  the traced calls, it brings what ``numbers`` reads to rank 0."""
