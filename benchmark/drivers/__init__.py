"""One driver a kind of traffic: ``analyze`` (closed-loop capture analysis),
``live`` (an open-loop sender into a live sniffer).  A driver's ``Cell`` makes the inputs
from the seed, sets up and warms the program, runs the window, frees the
program's state and checks what the window produced against the reference."""
