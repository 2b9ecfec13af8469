"""The benchmark's plain reference: recounts of a partition and the rules' supersteps."""
