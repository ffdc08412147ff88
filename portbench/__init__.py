"""The benchmark of nimble_tpu_torch, the PyTorch and CUDA port, on one H100.

``python3 -m portbench.run --workload CELL --seed N --seconds S --trace 0|1``
runs one cell (``run.py``); ``python3 -m portbench.control`` reads the
check's control; ``python -m pytest portbench/tests`` holds the harness on
the CPU (``-m cuda`` on the card).  Everything of a cell is a file found by
name (``spec.py``): ``configs/``, ``traffic/``, ``cells/``, ``paths/`` and
``metrics/``.  The yardstick is here and imports nothing of the program:
the generators (``generate.py``), the plain reference
(``reference/``), the kernel byte count (``roofline.py``) and the trace
reduction (``trace.py``, ``readers.py``); beside each pass of the window, the
host's load (``hostload.py``).
"""
