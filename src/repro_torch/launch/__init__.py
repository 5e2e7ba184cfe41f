"""Launchers of the port (mirror of ``repro/launch``): device meshes
(``mesh``), the trainer (``train``), the serving names' compatibility
module (``serve``), the roofline terms (``roofline``), the production
cells' settings (``cell_configs``) and the dry-run (``dryrun``)."""
