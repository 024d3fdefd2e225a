"""The port's data fabrics: the framed-TCP engine (:mod:`.tcp`)."""
