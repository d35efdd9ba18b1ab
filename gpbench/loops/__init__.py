"""Per kind of traffic: the loop that generates it, times it and checks it."""
