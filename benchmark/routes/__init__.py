"""Reciprocal routes, one module a route, named by the traffic's ``recip``:
the reference's plain reciprocal sum on that route and the route's work
count."""
