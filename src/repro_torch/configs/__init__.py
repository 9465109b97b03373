"""Architecture configurations of the port."""
