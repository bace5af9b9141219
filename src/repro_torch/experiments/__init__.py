"""Paper experiments driven through the port."""
