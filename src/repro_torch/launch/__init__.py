"""Launchers of the port (mirror of ``repro/launch``): the one-device
trainer (``train``) and the serving names' compatibility module
(``serve``)."""
