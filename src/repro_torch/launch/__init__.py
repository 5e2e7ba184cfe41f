"""Launchers of the port (mirror of ``repro/launch``): device meshes
(``mesh``), the trainer (``train``) and the serving names'
compatibility module (``serve``)."""
