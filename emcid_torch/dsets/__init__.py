"""Caption corpora for the covariance sweep."""
