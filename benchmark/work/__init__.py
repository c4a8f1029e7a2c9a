"""The work one GRAPE iteration's algorithm needs, counted from the
problem's sizes (one file per kind of problem), for the roofline metrics.

Each kind's ``per_seed(sizes)`` returns the operations and the bytes of
one Adam iteration of one problem, split into the bytes every seed of a
batch shares (the generators) and those each seed has alone.  The count
is of the reference GRAPE method and never of an implementation: no
kernel name, route or fusion enters it, remat's recomputation is not
counted, and each input is read once and each output written once, in
float32.
"""
