"""superstep_ms.spinner: `superstep_ms` in the Spinner cells, whose jobs the card
paces, apart from the host-paced Revolver cells, so that its bound is set
from Spinner's own spread (see `metrics/superstep_ms.py`)."""
from partbench import harness

read = harness.load_reader("superstep_ms")
