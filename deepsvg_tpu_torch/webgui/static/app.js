/* deepsvg-tpu editor client.
 *
 * Stateless renderer over the server's editor snapshot: every interaction
 * POSTs to /api/* and re-renders from the returned state, so the Python
 * state machine (deepsvg_tpu_torch/editor.py) stays the single source of truth.
 *
 * Canvas is 512x512 over the 256x256 viewbox (scale 2). Editor space is
 * y-UP (the reference's Kivy convention); canvas is y-down — mirrored here.
 */
"use strict";

const canvas = document.getElementById("canvas");
const ctx = canvas.getContext("2d");
const SCALE = canvas.width / 256;
const PALETTE = ["#d62728", "#1f77b4", "#2ca02c", "#9467bd", "#ff7f0e",
                 "#8c564b", "#e377c2", "#17becf"];

let state = null;        // last server snapshot
let playing = false;
let playTimer = null;
let mouseDown = false;

// -- transport --------------------------------------------------------------

async function api(route, body) {
  const res = await fetch("/api/" + route, {
    method: "POST",
    headers: {"Content-Type": "application/json"},
    body: JSON.stringify(body || {}),
  });
  const data = await res.json();
  if (!res.ok) { toast(data.error || res.statusText); throw new Error(data.error); }
  if (data.state) { state = data.state; render(); }
  return data;
}

// Latest-wins pointer-move sender: never more than one in flight.
let moveInflight = false, movePending = null;
async function sendMove(kind, pos) {
  movePending = {type: kind, pos: pos};
  if (moveInflight) return;
  moveInflight = true;
  while (movePending) {
    const ev = movePending; movePending = null;
    try { await api("pointer", ev); } catch (e) { break; }
  }
  moveInflight = false;
}

function toast(msg) {
  const el = document.getElementById("status");
  el.textContent = msg;
  setTimeout(() => { if (el.textContent === msg) el.textContent = ""; }, 4000);
}

// -- coordinates ------------------------------------------------------------

function toEditor(ev) {
  const r = canvas.getBoundingClientRect();
  const x = (ev.clientX - r.left) * (canvas.width / r.width) / SCALE;
  const y = (ev.clientY - r.top) * (canvas.height / r.height) / SCALE;
  return [x, 255 - y];
}
function cx(p) { return p[0] * SCALE; }
function cy(p) { return (255 - p[1]) * SCALE; }

// -- rendering --------------------------------------------------------------

function drawPath(path, color, withHandles) {
  if (!path.segments.length) return;
  ctx.strokeStyle = color;
  ctx.lineWidth = 2;
  ctx.beginPath();
  for (const s of path.segments) {
    ctx.moveTo(cx(s.p1), cy(s.p1));
    if (s.is_curved) ctx.bezierCurveTo(cx(s.q1), cy(s.q1), cx(s.q2), cy(s.q2),
                                       cx(s.p2), cy(s.p2));
    else ctx.lineTo(cx(s.p2), cy(s.p2));
  }
  ctx.stroke();
  if (!withHandles) return;
  for (const s of path.segments) {
    if (s.is_curved) {
      ctx.strokeStyle = "#b0b6c0"; ctx.lineWidth = 1;
      ctx.beginPath();
      ctx.moveTo(cx(s.p1), cy(s.p1)); ctx.lineTo(cx(s.q1), cy(s.q1));
      ctx.moveTo(cx(s.p2), cy(s.p2)); ctx.lineTo(cx(s.q2), cy(s.q2));
      ctx.stroke();
      for (const q of [s.q1, s.q2]) {
        ctx.fillStyle = "#fff"; ctx.strokeStyle = "#5b8def";
        ctx.beginPath(); ctx.arc(cx(q), cy(q), 3.5, 0, 7); ctx.fill(); ctx.stroke();
      }
    }
    for (const p of [s.p1, s.p2]) {
      ctx.fillStyle = "#5b8def";
      ctx.fillRect(cx(p) - 3.5, cy(p) - 3.5, 7, 7);
    }
  }
}

function render() {
  if (!state) return;
  ctx.clearRect(0, 0, canvas.width, canvas.height);
  for (const p of state.paths)
    drawPath(p, p.color || PALETTE[p.index % PALETTE.length],
             p.selected && state.tool === 0 && !playing);
  if (state.current_path)
    drawPath(state.current_path, "#444", true);
  if (state.sketch && state.sketch.length >= 4) {
    ctx.strokeStyle = "#444"; ctx.lineWidth = 2;
    ctx.beginPath();
    ctx.moveTo(state.sketch[0] * SCALE, (255 - state.sketch[1]) * SCALE);
    for (let i = 2; i < state.sketch.length; i += 2)
      ctx.lineTo(state.sketch[i] * SCALE, (255 - state.sketch[i + 1]) * SCALE);
    ctx.stroke();
  }
  // chrome
  for (const b of document.querySelectorAll("#tools [data-tool]"))
    b.classList.toggle("active", +b.dataset.tool === state.tool);
  document.getElementById("tool-play").classList.toggle("active", playing);
  document.getElementById("loop-mode").value = state.loop_mode;
  document.getElementById("ease-mode").value = state.playback_mode;
  document.getElementById("btn-interpolate").disabled = !state.has_session;
  canvas.classList.toggle("move-tool", state.tool === 0);
  renderTimeline();
}

function renderTimeline() {
  const tl = document.getElementById("timeline");
  tl.innerHTML = "";
  state.timeline.frames.forEach((key, i) => {
    const el = document.createElement("div");
    el.className = "frame" + (key ? " keyframe" : "")
      + (i === state.timeline.selected ? " selected" : "");
    el.textContent = i + 1;
    el.onclick = () => api("frame/select", {index: i});
    tl.appendChild(el);
  });
}

// -- pointer events ---------------------------------------------------------

canvas.addEventListener("mousedown", (ev) => {
  if (playing) return;
  mouseDown = true;
  api("pointer", {type: "down", pos: toEditor(ev)});
});
canvas.addEventListener("mousemove", (ev) => {
  if (playing || !state) return;
  const pos = toEditor(ev);
  if (mouseDown)
    sendMove(state.tool === 1 ? "drag" : "move", pos);
  else if (state.tool === 1 && state.draw_mode === 1)
    sendMove("move", pos);   // pen hover preview
});
window.addEventListener("mouseup", () => {
  if (!mouseDown) return;
  mouseDown = false;
  if (!playing) api("pointer", {type: "up"});
});
canvas.addEventListener("dblclick", () => {
  if (state && state.tool === 1) api("pen/finish");
});

// -- toolbar ----------------------------------------------------------------

for (const b of document.querySelectorAll("#tools [data-tool]"))
  b.onclick = () => api("tool", {tool: +b.dataset.tool});

document.getElementById("tool-play").onclick = togglePlay;
document.getElementById("btn-copy").onclick = () => api("path/copy");
document.getElementById("btn-paste").onclick = () => api("path/paste");
document.getElementById("btn-add-frame").onclick = () => api("frame/add");
document.getElementById("btn-keyframe").onclick = () =>
  api("frame/keyframe", {value: !state.timeline.frames[state.timeline.selected]});
document.getElementById("loop-mode").onchange = (e) =>
  api("playback", {loop_mode: +e.target.value});
document.getElementById("ease-mode").onchange = (e) =>
  api("playback", {playback_mode: +e.target.value});
document.getElementById("btn-save").onclick = async () => {
  const r = await api("project/save");
  toast("saved " + r.saved);
};
document.getElementById("btn-gif").onclick = async () => {
  const r = await api("export/gif");
  toast("exported " + r.gif);
};
document.getElementById("btn-interpolate").onclick = async () => {
  toast("interpolating…");
  await api("interpolate");
  toast("interpolated");
};

function togglePlay() {
  playing = !playing;
  if (playTimer) { clearTimeout(playTimer); playTimer = null; }
  if (playing) stepPlayback();
  render();
}
async function stepPlayback() {
  if (!playing) return;
  const r = await api("play/next");
  playTimer = setTimeout(stepPlayback, r.delay * 1000);
}

window.addEventListener("keydown", (ev) => {
  if (ev.target.tagName === "SELECT") return;
  const k = ev.key.toLowerCase();
  if (k === "v") api("tool", {tool: 0});
  else if (k === "p") api("tool", {tool: 1});
  else if (k === "b") api("tool", {tool: 2});
  else if (k === " ") { ev.preventDefault(); togglePlay(); }
});

// -- boot -------------------------------------------------------------------

fetch("/api/state").then(r => r.json()).then(s => { state = s; render(); });
