"""Quality of service: the priority classes the serving engine seats by."""
