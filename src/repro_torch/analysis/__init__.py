"""Analysis of the port's own artifacts: ``traceview`` validates the
engine's metrics snapshot and Chrome trace and sets the paper's BOPs cost
model against the measured phase times."""
