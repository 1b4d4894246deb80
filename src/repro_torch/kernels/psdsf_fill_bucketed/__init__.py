"""Bucketed whole-cluster bisection fill: one saturation event for every
server on its eligibility bucket (``kernel``), the freeze-and-repeat event
loop around it (``ops``) and the plain PyTorch version of both (``ref``)."""
