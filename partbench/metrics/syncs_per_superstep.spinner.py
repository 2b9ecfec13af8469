"""syncs_per_superstep.spinner: `syncs_per_superstep` in the Spinner cells, whose jobs the card
paces, apart from the host-paced Revolver cells, so that its bound is set
from Spinner's own spread (see `metrics/syncs_per_superstep.py`)."""
from partbench import harness

read = harness.load_reader("syncs_per_superstep")
