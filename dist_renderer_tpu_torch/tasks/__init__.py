"""The inverse-rendering command-line tasks and the render server, on the
card unless ``--cpu`` is given."""
