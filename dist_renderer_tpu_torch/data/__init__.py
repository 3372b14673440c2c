"""Dataset loaders: the depth-completion and multi-view on-disk layouts,
and the synthetic stand-in that renders the same observations."""
