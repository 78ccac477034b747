"""The harness: the loop, the window, the spans, the trace and the result."""
