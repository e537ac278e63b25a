"""Process groups and placement of the vocab-parallel mesh."""
