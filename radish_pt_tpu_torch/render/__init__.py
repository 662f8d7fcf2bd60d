"""Path tracing, post-processing and the frame driver."""
