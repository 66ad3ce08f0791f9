"""What the GKP engines share: the draw recorder of the window and the
check against the plain reference."""
