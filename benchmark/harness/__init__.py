"""The benchmark's harness: it finds a cell's configuration, traffic mix and
per-layer metrics by name (:mod:`.spec`), drives the port through the
window (:mod:`.session`), reads the trace (:mod:`.trace`) and holds what
the window produced against the plain reference (:mod:`.check`)."""
