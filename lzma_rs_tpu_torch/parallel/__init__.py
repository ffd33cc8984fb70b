"""The parallel runtime: planners, engines, lane batching over devices
(``mesh.py``), measurements (``devbench.py``) and the multi-process
decode (``multihost.py``)."""
